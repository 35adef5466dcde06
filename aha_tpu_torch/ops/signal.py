"""Signal processing of score traces: Savitzky-Golay smoothing and peak
detection, the port's copy of ``aha_tpu/ops/signal.py:23-172``.

The host helpers work on numpy arrays with scipy's semantics
(``savgol_filter(window 15, order 3)``, ``find_peaks`` with height,
prominence and distance); ``savgol_filter_torch`` is the same filter on
tensors of any device, over the last axis of [..., T]: the interior a fixed
1-D convolution, the first and last h points the projection of the first and
last window onto their least-squares polynomial (JAX's ``savgol_filter_jnp``).
``find_ticks`` is the live demo's tick recipe.
"""

from __future__ import annotations

import numpy as np
import torch


def savgol_coeffs(window_length: int, polyorder: int) -> np.ndarray:
    """Least-squares smoothing kernel: row 0 of (AᵀA)⁻¹Aᵀ for the centred
    Vandermonde A[i, j] = x_i^j, x in [-h, h]."""
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    if polyorder >= window_length:
        raise ValueError("polyorder must be < window_length")
    h = window_length // 2
    x = np.arange(-h, h + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)         # [W, p+1]
    return np.linalg.pinv(A)[0]                              # the fit's value at x = 0


def savgol_filter(x: np.ndarray, window_length: int = 15, polyorder: int = 3) -> np.ndarray:
    """scipy's 'interp' edge mode: interior points are the fixed convolution;
    the first / last h points come from polynomials fitted to the first /
    last window. A trace shorter than the window gets one polynomial fitted
    to all of it (scipy raises there)."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if n < window_length:
        deg = min(polyorder, n - 1)
        t = np.arange(n)
        return np.polyval(np.polyfit(t, x, deg), t)
    h = window_length // 2
    kernel = savgol_coeffs(window_length, polyorder)
    mid = np.convolve(x, kernel[::-1], mode="valid")          # [n - 2h]
    t = np.arange(window_length)
    head_poly = np.polyfit(t, x[:window_length], polyorder)
    tail_poly = np.polyfit(t, x[-window_length:], polyorder)
    head = np.polyval(head_poly, t[:h])
    tail = np.polyval(tail_poly, t[h + 1:])
    return np.concatenate([head, mid, tail])


def savgol_filter_torch(x: torch.Tensor, window_length: int = 15,
                        polyorder: int = 3) -> torch.Tensor:
    """Savitzky-Golay over the last axis of a tensor [..., T] (T >= the
    window), on its device and in its dtype: the interior a sliding-window
    product with the kernel, the edges small fit-evaluate products."""
    kernel = torch.as_tensor(savgol_coeffs(window_length, polyorder), dtype=x.dtype,
                             device=x.device)
    h = window_length // 2
    lead, T = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, T)
    windows = flat.unfold(-1, window_length, 1)               # [N, T-2h, W]
    mid = torch.einsum("ntw,w->nt", windows, kernel)
    # edge projections: head = P_head @ x[:W], tail = P_tail @ x[-W:]
    t = np.arange(window_length, dtype=np.float64)
    A = np.vander(t, polyorder + 1, increasing=True)
    proj = A @ np.linalg.pinv(A)                              # [W, W] fit-evaluate
    P_head = torch.as_tensor(proj[:h], dtype=x.dtype, device=x.device)
    P_tail = torch.as_tensor(proj[h + 1:], dtype=x.dtype, device=x.device)
    head = torch.einsum("hw,nw->nh", P_head, flat[:, :window_length])
    tail = torch.einsum("hw,nw->nh", P_tail, flat[:, -window_length:])
    return torch.cat([head, mid, tail], dim=-1).reshape(*lead, T)


def find_peaks(x: np.ndarray, height: float | None = None, prominence: float | None = None,
               distance: int | None = None) -> np.ndarray:
    """Local maxima with scipy's height / prominence / distance filters, in
    scipy's order (height, distance, prominence): a flat peak reports its
    middle; distance pruning keeps higher peaks first (on a tie the later
    one); a peak's prominence is taken against the higher of the two
    flanking minima up to the nearest higher sample."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    peaks: list[int] = []
    i = 1
    while i < n - 1:
        if x[i - 1] < x[i]:
            j = i                                # a peak or the start of a plateau
            while j < n - 1 and x[j + 1] == x[i]:
                j += 1
            if j < n - 1 and x[j + 1] < x[i]:
                peaks.append((i + j) // 2)
            i = j + 1
        else:
            i += 1
    peaks_arr = np.asarray(peaks, np.int64)

    if height is not None and peaks_arr.size:
        peaks_arr = peaks_arr[x[peaks_arr] >= height]

    if distance is not None and distance > 1 and peaks_arr.size:
        keep = np.ones(peaks_arr.size, bool)
        order = np.argsort(x[peaks_arr], kind="stable")[::-1]
        for k in order:
            if not keep[k]:
                continue
            too_close = np.abs(peaks_arr - peaks_arr[k]) < distance
            too_close[k] = False
            keep[too_close] = False
        peaks_arr = peaks_arr[keep]

    if prominence is not None and peaks_arr.size:
        peaks_arr = peaks_arr[_prominences(x, peaks_arr) >= prominence]

    return peaks_arr


def _prominences(x: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    out = np.empty(peaks.size)
    for idx, p in enumerate(peaks):
        left_min = x[p]
        i = p - 1
        while i >= 0 and x[i] <= x[p]:
            left_min = min(left_min, x[i])
            i -= 1
        right_min = x[p]
        i = p + 1
        while i < x.size and x[i] <= x[p]:
            right_min = min(right_min, x[i])
            i += 1
        out[idx] = x[p] - max(left_min, right_min)
    return out


def find_ticks(scores: np.ndarray, fps: float, min_separation: float = 10.0,
               prominence: float = 0.02, thresh: float | None = None) -> list[float]:
    """Highlight tick times in seconds: savgol(15, 3), then the peaks above
    mean + 0.5 std of the smoothed trace (or ``thresh``) with the given
    prominence, at least ``min_separation`` seconds apart."""
    scores = np.asarray(scores, np.float64)
    smoothed = savgol_filter(scores, 15, 3)
    if thresh is None:
        thresh = float(smoothed.mean() + 0.5 * smoothed.std())
    distance = int(min_separation * fps)
    peaks = find_peaks(smoothed, height=thresh, prominence=prominence,
                       distance=max(distance, 1))
    return list(np.sort(peaks) / fps)
