"""Model functions of the port: SigLIP tower, Qwen2 decoder, Aha heads."""


def layer_view(tree, i: int):
    """Layer ``i`` of a layer-stacked param subtree ([L, ...] leaves, int8
    dicts included): views of the stacked tensors, no copy."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]
