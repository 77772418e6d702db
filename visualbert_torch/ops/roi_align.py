"""RoIAlign (counterpart of ``visualbert_tpu/ops/roi_align.py``; the
reference runs torchvision's ``ROIAlign((7, 7), spatial_scale=1/16,
sampling_ratio=0)``, ``visualbert/utils/detector.py:71-73``).

The JAX package computes this as two einsums, not as a Pallas kernel, and so
does the port: the same function in ``torch.einsum`` form, on NCHW feature
maps.

* **Static shapes**: all N padded boxes of an image are aligned ([B, N, ...]
  in and out); padded boxes give values that downstream masks ignore.
* **Adaptive sampling on a static lattice**: torchvision's
  ``sampling_ratio=0`` samples each bin with ``ceil(bin_size)`` bilinear taps
  per axis. Here every bin gets an ``S`` x ``S`` lattice whose spacing comes
  from the box's adaptive count and whose taps beyond it weigh zero, with
  ``S = min(max_samples, max(ceil(H/out), ceil(W/out)))``: a box inside the
  feature map never needs more taps than the whole map would. The
  quadrature is torchvision's for every box inside the map
  (``SimpleDetector`` clips boxes to the image first); a positive
  ``sampling_ratio`` is torchvision's fixed grid.
* **Matmul form (default)**: a tap at clamped coordinate ``p`` gives
  ``relu(1 - |p - h|)`` to feature-grid cell ``h`` (the two-neighbour lerp,
  the border clamp included). Folding the taps' quadrature weights in gives
  one interpolation matrix a box and axis, ``M[out, H] = sum_taps w *
  relu(1 - |p - h|)``, and RoIAlign is ``M_y . fm . M_x^T``. The matrices
  are fp32, the feature map is promoted to fp32 for both contractions and
  the result is cast back to ``features.dtype``.
* ``implementation="gather"`` keeps the bilinear taps as gathers, for
  cross-checks.

Coordinates follow torchvision's ``aligned=False`` (no -0.5 pixel offset).
"""

from __future__ import annotations

import torch


def _bilinear_gather(fm: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """fm: [C, H, W]; ys/xs: [P] fractional coordinates. Returns [P, C].
    Coordinates clamp to the border (boxes are clipped to the image)."""
    _, H, W = fm.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = ys.floor().long()
    x0 = xs.floor().long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy1 = ys - y0.to(ys.dtype)
    wx1 = xs - x0.to(xs.dtype)
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    flat = fm.reshape(fm.shape[0], H * W).t()  # [H*W, C]

    def take(yi, xi):
        return flat[yi * W + xi]

    return (take(y0, x0) * (wy0 * wx0)[:, None] + take(y0, x1) * (wy0 * wx1)[:, None]
            + take(y1, x0) * (wy1 * wx0)[:, None] + take(y1, x1) * (wy1 * wx1)[:, None])


def _grid(boxes: torch.Tensor, out_size: int, S: int, sampling_ratio: int, scale: float):
    """Sample coordinates and quadrature weights of [N, 4] boxes: ys/xs
    [N, out*S] along each axis, w_h/w_w [N, S] (0 beyond the adaptive count;
    a bin's weights sum to 1 along an axis)."""
    x1, y1, x2, y2 = (boxes[:, i] * scale for i in range(4))
    roi_w = (x2 - x1).clamp_min(1.0)  # torchvision clamps the roi size to >= 1
    roi_h = (y2 - y1).clamp_min(1.0)
    bin_w = roi_w / out_size
    bin_h = roi_h / out_size
    if sampling_ratio > 0:
        n_h = torch.full_like(bin_h, float(sampling_ratio))
        n_w = torch.full_like(bin_w, float(sampling_ratio))
    else:  # adaptive: ceil(bin) taps an axis (torchvision sampling_ratio=0)
        n_h = bin_h.ceil().clamp(1, S)
        n_w = bin_w.ceil().clamp(1, S)
    j = torch.arange(S, dtype=torch.float32, device=boxes.device)  # tap index within a bin
    off_h = (j[None, :] + 0.5) / n_h[:, None]  # [N, S], in bin units
    off_w = (j[None, :] + 0.5) / n_w[:, None]
    zero = torch.zeros((), device=boxes.device)
    w_h = torch.where(j[None, :] < n_h[:, None], 1.0 / n_h[:, None], zero)
    w_w = torch.where(j[None, :] < n_w[:, None], 1.0 / n_w[:, None], zero)
    i = torch.arange(out_size, dtype=torch.float32, device=boxes.device)  # bin index
    ys = y1[:, None, None] + bin_h[:, None, None] * (i[None, :, None] + off_h[:, None, :])  # [N, out, S]
    xs = x1[:, None, None] + bin_w[:, None, None] * (i[None, :, None] + off_w[:, None, :])
    N = boxes.shape[0]
    return ys.reshape(N, out_size * S), xs.reshape(N, out_size * S), w_h, w_w


def _interp_matrix(p: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
    """p: [N, out, S] tap coordinates (feature-grid units), w: [N, S] their
    quadrature weights. Returns [N, out, size]: each grid cell's total
    weight for an output bin, ``sum_taps w * max(0, 1 - |clip(p) - cell|)``."""
    p = p.clamp(0.0, size - 1.0)
    g = torch.arange(size, dtype=p.dtype, device=p.device)
    tri = (1.0 - (p[..., None] - g).abs()).clamp_min(0.0)  # [N, out, S, size]
    return (tri * w[:, None, :, None]).sum(dim=2)


def roi_align(
    features: torch.Tensor,  # [B, C, H, W] (NCHW)
    boxes: torch.Tensor,     # [B, N, 4] (x1, y1, x2, y2) image pixels
    out_size: int = 7,
    sampling_ratio: int = 0,
    spatial_scale: float = 1.0 / 16,
    max_samples: int = 8,
    implementation: str = "matmul",
) -> torch.Tensor:
    """Returns [B, N, C, out_size, out_size] in ``features.dtype``.

    ``sampling_ratio=0`` (default) is torchvision's adaptive quadrature,
    exact for every box inside the feature map; the tap budget an axis is
    ``min(max_samples, max(ceil(H/out), ceil(W/out)))``. ``implementation``:
    "matmul" (default; two contractions, no tap tensor) or "gather" (the
    bilinear taps as gathers); both give the same numbers."""
    if implementation not in ("matmul", "gather"):
        raise ValueError(f"implementation must be 'matmul' or 'gather', got {implementation!r}")
    B, C, H, W = features.shape
    N = boxes.shape[1]
    S = max_samples if sampling_ratio <= 0 else sampling_ratio
    if sampling_ratio <= 0:
        # an in-image RoI spans at most (H, W) cells, so its adaptive tap
        # count ceil(roi / out_size) never exceeds ceil(fm_dim / out_size)
        S = min(S, max(1, -(-H // out_size), -(-W // out_size)))
    P = out_size * S
    ys, xs, w_h, w_w = _grid(boxes.reshape(B * N, 4).float(), out_size, S, sampling_ratio, spatial_scale)
    if implementation == "matmul":
        m_y = _interp_matrix(ys.view(B * N, out_size, S), w_h, H).view(B, N, out_size, H)
        m_x = _interp_matrix(xs.view(B * N, out_size, S), w_w, W).view(B, N, out_size, W)
        fm = features.float()
        t = torch.einsum("bnih,bchw->bnciw", m_y, fm)      # contract rows
        out = torch.einsum("bnkw,bnciw->bncik", m_x, t)    # contract columns
        return out.to(features.dtype)
    outs = []
    for b in range(B):
        sl = slice(b * N, (b + 1) * N)
        ys_full = ys[sl][:, :, None].expand(N, P, P).reshape(N * P * P)
        xs_full = xs[sl][:, None, :].expand(N, P, P).reshape(N * P * P)
        samples = _bilinear_gather(features[b], ys_full, xs_full).view(N, out_size, S, out_size, S, C)
        w = w_h[sl][:, None, :, None, None, None] * w_w[sl][:, None, None, None, :, None]
        outs.append((samples * w.to(samples.dtype)).sum(dim=(2, 4)).permute(0, 3, 1, 2))
    return torch.stack(outs).to(features.dtype)
