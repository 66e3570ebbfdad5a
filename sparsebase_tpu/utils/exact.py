"""Exact integer arithmetic on the device: totals and ratios.

Device reductions have no int64 (x64 is off) and f32 sums lose
exactness once the total passes 2**24 — the failure mode the round-2
matmul triangle paths hit (reference semantics they must match:
src/sparsebase/feature/triangle_count.cc:141-205, which accumulates in
int64_t on host). The fix used here: compute the same sum twice on
device —

* ``wrapped``: an int32 sum. Integer adds wrap mod 2**32, so this is
  the exact total modulo 2**32, regardless of magnitude.
* ``approx``: an f32 sum. XLA lowers reductions as trees, so the
  absolute error is ~total * 2**-24 * log2(N) — far below 2**31 for any
  total up to ~10**13.

``combine_wrapped`` snaps the approximation to the unique integer
congruent to ``wrapped`` mod 2**32 within the error window, recovering
the exact total on host at int64+ precision.
"""

from __future__ import annotations

_TWO32 = 1 << 32


def combine_wrapped(wrapped: int, approx: float) -> int:
    """Exact integer total from (int32-wrapped sum, f32 approximate sum).

    Valid whenever the f32 sum's absolute error is < 2**31 — true for
    totals up to ~10**13 under XLA's tree reductions.
    """
    r = int(wrapped) & (_TWO32 - 1)
    k = round((float(approx) - r) / _TWO32)
    return r + int(k) * _TWO32


_RATIO_STEPS = 50  # ≤24 leading zero bits + 24 significant + 1 round bit


def ratio_f32(num, den):
    """Correctly rounded float32 ``num / den`` for int32 arrays with
    ``0 <= num < 2**24`` and ``1 <= den < 2**24``, on any backend.

    A float32 divide on the GPU may be off by one unit in the last place,
    while the host references (``native.jaccard``, ``_jaccard_host``)
    round the exact quotient. Here the quotient's bits come from integer
    long division (remainders stay below ``2 * den < 2**25``), and the
    24 significant bits are rounded to nearest-even from the next bit and
    the remainder, so the result equals the host's bit for bit."""
    import jax
    import jax.numpy as jnp

    num = jnp.asarray(num, jnp.int32)
    den = jnp.asarray(den, jnp.int32)
    ip = num // den

    def bitlen(v):
        return 32 - jax.lax.clz(v)

    def step(_, c):
        r, m, f, rnd, took_rnd, sticky = c
        r2 = 2 * r
        bit = (r2 >= den).astype(jnp.int32)
        r = r2 - bit * den
        full = bitlen(m) >= 24
        take_mant = ~full
        take_rnd = full & ~took_rnd
        m = jnp.where(take_mant, 2 * m + bit, m)
        f = jnp.where(take_mant, f + 1, f)
        rnd = jnp.where(take_rnd, bit, rnd)
        sticky = sticky | (full & took_rnd & (bit == 1))
        return r, m, f, rnd, took_rnd | take_rnd, sticky

    zero = jnp.zeros_like(num)
    # integer part first: ip < 2**24 is already exact
    init = (num - ip * den, ip, zero, zero, zero.astype(bool), zero.astype(bool))
    r, m, f, rnd, _, sticky = jax.lax.fori_loop(0, _RATIO_STEPS, step, init)
    sticky = sticky | (r != 0)
    up = (rnd == 1) & (sticky | ((m & 1) == 1))  # round to nearest, ties even
    m = m + up.astype(jnp.int32)
    # 2**-f as exact float32 bits (f <= 48 keeps it a normal number)
    scale = jax.lax.bitcast_convert_type((127 - f) << 23, jnp.float32)
    return m.astype(jnp.float32) * scale
