"""Runtime telemetry: a device-memory / host-RSS monitor, a step timer, a
profiler scope and a flop and byte count of a function.

Counterpart of ``aha_tpu/utils/telemetry.py`` (the reference's NVML
``GpuMonitor`` thread and its psutil RAM report). ``DeviceMonitor`` keeps its
fields, its sampling thread and its ``report()`` keys; a sample's device
bytes are ``torch.cuda.memory_allocated`` summed over the devices the session
uses (the caching allocator's live tensors, where JAX reads XLA's
``bytes_in_use``), 0 on the CPU. ``profile_trace`` wraps ``torch.profiler``
(a no-op at ``None``), and ``flops_estimate`` counts what a function does by
running it.
"""

from __future__ import annotations

import contextlib
import threading
import time


class DeviceMonitor:
    """Background sampler of device memory and host RSS. ``devices``: the
    CUDA devices to sum (default: every visible one; none without a card)."""

    def __init__(self, sample_interval_seconds: float = 0.2, devices=None):
        import torch

        self.interval = sample_interval_seconds
        if devices is None:
            devices = range(torch.cuda.device_count()) if torch.cuda.is_available() else ()
        self.devices = [torch.device(d) if not isinstance(d, int) else torch.device("cuda", d)
                        for d in devices]
        self.devices = [d for d in self.devices if d.type == "cuda"]
        self.peak_device_bytes = 0
        self.peak_host_bytes = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _sample_once(self):
        import torch

        total = sum(torch.cuda.memory_allocated(d) for d in self.devices)
        self.peak_device_bytes = max(self.peak_device_bytes, total)
        try:
            import psutil

            rss = psutil.Process().memory_info().rss
        except Exception:
            import resource

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        self.peak_host_bytes = max(self.peak_host_bytes, rss)
        self.samples += 1

    def _run(self):
        while not self._stop.is_set():
            self._sample_once()
            self._stop.wait(self.interval)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._sample_once()

    def get_peak_hbm_gb(self) -> float:
        return self.peak_device_bytes / 1024**3

    def get_peak_ram_gb(self) -> float:
        return self.peak_host_bytes / 1024**3

    def report(self) -> dict:
        return {
            "peak_hbm_gb": round(self.get_peak_hbm_gb(), 3),
            "peak_ram_gb": round(self.get_peak_ram_gb(), 3),
            "samples": self.samples,
        }


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the scope (CPU, and CUDA where there is
    a card) written under ``logdir`` as a Chrome / TensorBoard trace; a no-op
    when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def flops_estimate(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its work: ``flops`` from
    ``torch.utils.flop_counter.FlopCounterMode`` (2 M N K a product) and
    ``bytes_accessed`` as the input and output bytes of every aten op it
    dispatches (views excluded: they move nothing). For one product this is
    XLA's ``cost_analysis`` count, (M K + K N + M N) x itemsize. On a larger
    graph the two part: XLA counts a fused region's operands once, here each
    op reads and writes its tensors, intermediates included."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.total += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    counter = FlopCounterMode(display=False)
    with counter, _Bytes() as nbytes:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float(nbytes.total)}


class StepTimer:
    """Per-step wall-clock stats (mean, p50, p90, max) of a hot loop."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {"n": 0}
        import numpy as np

        arr = np.asarray(self.times)
        return {
            "n": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }
