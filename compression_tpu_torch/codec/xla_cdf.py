"""PMF -> quantized CDF as plain torch ops on any device (counterpart of
``compression_tpu/codec/xla_cdf.py`` ``pmf_to_quantized_cdf_xla``).

The same algorithm as the C++ quantizer
(:func:`compression_tpu_torch.codec.host.pmf_to_quantized_cdf`), row for
row, in float64: invalid or non-positive entries zeroed, all-zero rows made
uniform, ``q = max(1, llround(p / sum(p) * 2**precision))``, then the greedy
repair that adds a unit where ``p * log((q + 1) / q)`` is largest or removes
one where ``p * log(q / (q - 1))`` is smallest (among ``q > 1``) until the
row sums to ``2**precision``; the first index wins ties (``torch.argmax`` /
``argmin`` return the first occurrence). All rows run at once: a step of the
repair moves every row that is not yet done.

The C++ quantizer stays the one the range-coder tables are built with. On a
device whose float64 ``log`` differs from the host's libm by an ulp, a tie
between two gains can break the other way and give another row.
"""

from __future__ import annotations

import torch

__all__ = ["pmf_to_quantized_cdf_torch"]

# Rows re-checked for completion every this many repair steps (one host
# sync each); a row that is done is left as it is by the steps in between.
_CHECK_EVERY = 8


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """Each row's sum, accumulated left to right on the CPU as the C++ loop
    does (a cumulative sum's last entry); the card's scan may round the
    last bit differently."""
    return torch.cumsum(p, dim=1)[:, -1:]


def pmf_to_quantized_cdf_torch(pmf: torch.Tensor, pmf_lengths: torch.Tensor,
                               precision: int) -> torch.Tensor:
    """Quantizes float64 PMF rows ``[num, max_len]`` (valid lengths in
    ``pmf_lengths``) to int32 CDF rows ``[num, max_len + 1]`` on the rows'
    device; entries past ``length + 1`` are zero (the C++ convention).
    Raises for any dtype but float64, as the JAX function does without
    x64: float32 would round and break ties differently from the C++
    quantizer."""
    if pmf.dtype != torch.float64:
        raise ValueError(
            f"pmf_to_quantized_cdf_torch needs float64 PMF rows, got {pmf.dtype}: "
            "float32 would not match the C++ quantizer bit for bit")
    if pmf.ndim == 1:
        pmf = pmf[None]
        pmf_lengths = pmf_lengths.reshape(1)
    device = pmf.device
    num, n = pmf.shape
    total = 1 << precision
    lengths = pmf_lengths.to(device=device, dtype=torch.int64).reshape(num, 1)
    if bool(((lengths < 1) | (lengths > min(n, total))).any()):
        raise ValueError("each row needs 1 <= length <= min(max_len, 2**precision)")
    valid = torch.arange(n, device=device)[None, :] < lengths
    p = torch.where(valid & torch.isfinite(pmf) & (pmf > 0), pmf,
                    torch.zeros((), dtype=pmf.dtype, device=device))
    s = _row_sum(p)
    p = torch.where(s > 0, p, valid.to(pmf.dtype))
    s = _row_sum(p)
    x = p / s * float(total)
    # llround: half away from zero (x >= 0; x - floor(x) is exact).
    fl = torch.floor(x)
    rounded = fl + (x - fl >= 0.5).to(x.dtype)
    q = torch.where(valid, torch.clamp(rounded, min=1.0).to(torch.int64),
                    torch.zeros((), dtype=torch.int64, device=device))
    neg_inf = torch.tensor(-float("inf"), dtype=pmf.dtype, device=device)
    pos_inf = torch.tensor(float("inf"), dtype=pmf.dtype, device=device)
    while True:
        t = q.sum(dim=1)
        if not bool((t != total).any()):
            break
        for _ in range(_CHECK_EVERY):
            t = q.sum(dim=1)
            qf = q.to(pmf.dtype)
            gain = torch.where(valid, p * torch.log((qf + 1.0) / qf), neg_inf)
            loss = torch.where(
                valid & (q > 1),
                p * torch.log(qf / torch.clamp(qf - 1.0, min=1e-300)), pos_inf)
            inc = t < total
            target = torch.where(inc, gain.argmax(dim=1), loss.argmin(dim=1))
            step = torch.where(inc, 1, -1) * (t != total)
            q.scatter_add_(1, target[:, None], step[:, None])
    cdf = torch.cat([torch.zeros((num, 1), dtype=torch.int64, device=device),
                     torch.cumsum(q, dim=1)], dim=1)
    keep = torch.arange(n + 1, device=device)[None, :] <= lengths
    return torch.where(keep, cdf, 0).to(torch.int32)
