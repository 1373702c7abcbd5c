"""4x4 matrix helpers: multiply and analytic adjugate inverse.

Port of clpathtracer_tpu/core/matrix.py. The product is written as
elementwise f32 arithmetic, so no matmul unit (and no TF32) is involved
on any device.
"""

from __future__ import annotations

import torch


def mat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] @ [..., 4, 4] row-major product in full f32, each
    entry summed left to right."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def mat_inverse(m: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a [..., 4, 4] matrix via the adjugate.

    Returns the zero matrix where `m` is singular (det == 0), matching the
    reference's error convention.
    """
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    e, f, g, h = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]
    i, j, k, l = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3]
    mm, n, o, p = m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3]

    # 2x2 sub-determinants of the bottom two rows and top two rows
    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm

    af_be = a * f - b * e
    ag_ce = a * g - c * e
    ah_de = a * h - d * e
    bg_cf = b * g - c * f
    bh_df = b * h - d * f
    ch_dg = c * h - d * g

    # cofactors, already transposed into the adjugate layout
    adj00 = f * kp_lo - g * jp_ln + h * jo_kn
    adj01 = -(b * kp_lo - c * jp_ln + d * jo_kn)
    adj02 = n * ch_dg - o * bh_df + p * bg_cf
    adj03 = -(j * ch_dg - k * bh_df + l * bg_cf)

    adj10 = -(e * kp_lo - g * ip_lm + h * io_km)
    adj11 = a * kp_lo - c * ip_lm + d * io_km
    adj12 = -(mm * ch_dg - o * ah_de + p * ag_ce)
    adj13 = i * ch_dg - k * ah_de + l * ag_ce

    adj20 = e * jp_ln - f * ip_lm + h * in_jm
    adj21 = -(a * jp_ln - b * ip_lm + d * in_jm)
    adj22 = mm * bh_df - n * ah_de + p * af_be
    adj23 = -(i * bh_df - j * ah_de + l * af_be)

    adj30 = -(e * jo_kn - f * io_km + g * in_jm)
    adj31 = a * jo_kn - b * io_km + c * in_jm
    adj32 = -(mm * bg_cf - n * ag_ce + o * af_be)
    adj33 = i * bg_cf - j * ag_ce + k * af_be

    det = a * adj00 + b * adj10 + c * adj20 + d * adj30

    adj = torch.stack([
        torch.stack([adj00, adj01, adj02, adj03], dim=-1),
        torch.stack([adj10, adj11, adj12, adj13], dim=-1),
        torch.stack([adj20, adj21, adj22, adj23], dim=-1),
        torch.stack([adj30, adj31, adj32, adj33], dim=-1),
    ], dim=-2)
    singular = (det == 0)[..., None, None]
    safe_det = torch.where(det == 0, 1.0, det)
    inv = adj / safe_det[..., None, None]
    return torch.where(singular, torch.zeros_like(inv), inv)
