"""The card's published peaks and the least time a piece of work can take.

A frozen copy of the bound arithmetic of ``chip_smoke.py`` (``bound``,
``attention_bounds``, ``k2_bound``): each input read once, each output
written once, the products each kernel must do, against the published
dense peaks of one NVIDIA H100 SXM (the data sheet's rates at its 700 W
limit). f32 data is held to the tensor cores' TF32 rate over 3, the rate
of f32-accurate products on this card (three TF32 products per f32
product), so no share of an f32 roofline can pass 100%.
"""

from __future__ import annotations

PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 495e12 / 3}
MEM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str):
    """(seconds, 'operations' or 'bytes'): the least time for this work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def attention_bounds(b, n, nk, c, cv, dtype: str):
    """Seconds of K1-fwd, K1-dq and K1-dkv at (B, N, Nk, C, Cv): each input
    read once, each output written once; the products each must do (s and
    p v; s, dp and dq; s, dp, dk and dv)."""
    e = 2 if dtype == 'bfloat16' else 4
    q, k, v, o = b * n * c * e, b * nk * c * e, b * nk * cv * e, b * n * cv * e
    rows = b * n * 4
    mm = 2 * b * n * nk
    return {'fwd': bound(mm * (c + cv), q + k + v + o + rows, dtype)[0],
            'dq': bound(mm * (2 * c + cv), q + k + v + o + 2 * rows + q,
                        dtype)[0],
            'dkv': bound(mm * (2 * c + 2 * cv),
                         q + k + v + o + 2 * rows + k + v, dtype)[0]}


def k2_bound(shape, dtype: str) -> float:
    """Seconds of K2 at (n, t, h, w, cin, cm, cout, proj): y1, x and out
    once each, the weights and folded BN once (f32, as the kernel reads
    them); the products conv2, conv3 and the projection must do."""
    n, t, h, w, cin, cm, cout, proj = shape
    e = 2 if dtype == 'bfloat16' else 4
    pixels = n * t * h * w
    macs = 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    nbytes = pixels * (cm + cin + cout) * e + 4 * (macs + 2 * (cm + cout)
                                                   + 2 * cout * proj)
    return bound(2 * pixels * macs, nbytes, dtype)[0]
