"""Training on one card: LoRA adapters over a frozen quantised trunk, the
multi-part loss, AdamW with warmup-cosine decay, and the step / checkpoint
loop."""
