"""Counter-based RNG — a redesign of the reference's hash RNG.

The reference threads a *float* seed through every draw, advancing it by
0.1 twice per draw and hashing the resulting f32 bit patterns
(ref: CSVersion/ShaderCompute.hlsl:23-66).  That scheme is numerically
fragile: any IEEE-preserving compiler that folds ``(s+0.1)+0.1 -> s+0.2``
(XLA's algebraic simplifier does, and fxc is free to) changes the hashed
bits and thus the entire stream.  Per SURVEY.md §7 we replace the float
chain with a **counter-based u32 stream**: state advances by the golden
-ratio Weyl increment and each draw is a murmur3-style integer finalizer of
the new state.  Integer arithmetic is exact under every backend, so streams
are bit-identical across eager / jit / Pallas / interpret and across any
tiling or device-mesh sharding.

What is preserved from the reference, exactly:
- per-pixel determinism: the initial state is the reference's own
  ``baseHash`` of the absolute pixel coordinates
  (ref: ShaderCompute.hlsl:23-28, :295) — no time term (the reference's is
  commented out, :296);
- the multiplicative lane derivation (n, n*16807, n*48271) masked to 31
  bits (ref: hlsl:36-48);
- the sampling mappings: polar unit-disk (sqrt-radius) and cbrt-radius
  unit-sphere (ref: hlsl:50-66);
- the draw *count* per event (one state advance per scatter / jitter
  component), so ray-death stops the stream exactly as the reference's
  inout seed does.

Every function takes a u32 state array of any shape and returns
``(value(s), new_state)``; per-component values are SoA tuples.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# numpy scalars (not jnp arrays) so these inline as immediates inside
# Pallas kernels instead of becoming captured constants
_K = np.uint32(1103515245)
_WEYL = np.uint32(0x9E3779B9)     # golden-ratio increment
_M1 = np.uint32(0x85EBCA6B)       # murmur3 fmix32 constants
_M2 = np.uint32(0xC2B2AE35)
_MASK31 = np.uint32(0x7FFFFFFF)
_INV_U24 = np.float32(1.0 / 16777216.0)
_INV_I31 = np.float32(1.0 / 2147483648.0)
_TWO_PI = np.float32(6.28318530718)


def _u31_to_f32(n):
    """[0,1) from the low 31 bits.  The u32 value is masked to 31 bits and
    routed through i32 (Mosaic has no u32->f32 cast; the i32 hop is value
    -identical for non-negative inputs)."""
    return (n & _MASK31).astype(jnp.int32).astype(jnp.float32) * _INV_I31


def base_hash(px, py):
    """The reference's integer pixel hash (ref: ShaderCompute.hlsl:23-28)."""
    px = px.astype(jnp.uint32)
    py = py.astype(jnp.uint32)
    hx = _K * ((px >> 1) ^ py)
    hy = _K * ((py >> 1) ^ px)
    h32 = _K * (hx ^ (hy >> 3))
    return h32 ^ (h32 >> 16)


def fmix32(h):
    """murmur3 finalizer — full-avalanche 32-bit mix."""
    h = h.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * _M1
    h = h ^ (h >> 13)
    h = h * _M2
    h = h ^ (h >> 16)
    return h


def pixel_seed(px, py):
    """Initial u32 stream state for a pixel (ref seed: hlsl:295)."""
    return base_hash(px, py)


_FOLD = np.uint32(0xBB67AE85)  # sqrt(3) frac: distinct from the Weyl step


def fold_in(state, k):
    """Derive an independent stream from ``state`` and integer ``k``.

    Used by the "parallel" RNG mode to give every (pixel, sample) pair
    its own counter stream — samples become order-independent, so spp
    folds into the batch dimension (no sequential seed chain).  The fold
    constant differs from the draw increment so sample streams never
    alias a draw-advanced sequential stream."""
    k = jnp.asarray(k).astype(jnp.uint32)
    return fmix32(state.astype(jnp.uint32) + (k + np.uint32(1)) * _FOLD)


def _draw(state):
    """One state advance: Weyl step + finalize. Returns (u32 draw, state')."""
    state = state.astype(jnp.uint32) + _WEYL
    return fmix32(state), state


def hash1(state):
    """Uniform f32 in [0,1); one state advance (ref shape: hlsl:30-34).

    Uses the top 24 bits so the i32->f32 conversion is mantissa-exact
    (and Mosaic-lowerable; u32->f32 is not)."""
    n, state = _draw(state)
    v = (n >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) * _INV_U24
    return v, state


def hash2(state):
    """Two uniform f32 lanes in [0,1); one advance (ref shape: hlsl:36-41)."""
    n, state = _draw(state)
    n2 = n * np.uint32(48271)
    return (_u31_to_f32(n), _u31_to_f32(n2)), state


def hash3(state):
    """Three uniform f32 lanes in [0,1); one advance (ref shape: hlsl:43-48)."""
    n, state = _draw(state)
    n2 = n * np.uint32(16807)
    n3 = n * np.uint32(48271)
    return (_u31_to_f32(n), _u31_to_f32(n2), _u31_to_f32(n3)), state


def random_in_unit_disk(state):
    """Polar disk sample -> ((x, y), state') (ref: hlsl:50-57)."""
    (a, b), state = hash2(state)
    phi = b * _TWO_PI
    r = jnp.sqrt(a)
    return (r * jnp.sin(phi), r * jnp.cos(phi)), state


def random_in_unit_sphere(state):
    """Cbrt-radius sphere sample -> ((x, y, z), state') (ref: hlsl:59-66)."""
    (a, b, c), state = hash3(state)
    h = a * np.float32(2.0) - np.float32(1.0)  # cos-latitude in [-1, 1)
    phi = b * _TWO_PI
    # cbrt via exp(log/3) (Mosaic has no cbrt primitive); c >= 0 by
    # construction, guard the c == 0 lane
    r = jnp.where(c > 0,
                  jnp.exp(jnp.log(jnp.maximum(c, np.float32(1e-30)))
                          / np.float32(3.0)),
                  np.float32(0.0))
    s = jnp.sqrt(jnp.maximum(np.float32(1.0) - h * h, np.float32(0.0)))
    return (r * s * jnp.sin(phi), r * s * jnp.cos(phi), r * h), state


# ---- v1 fract-sin RNG (parity mode; ref: Shader_RT.fx:106-163) ----
#
# The pixel shader generation's RNG: a float2 state advanced by
# fract(sin(dot(state, (12.9898, 78.233))) * 43758.5453).  Its sampling
# helpers take the state BY VALUE (the reference's defect — the caller's
# state never advances through them), so along a v1 path only the two
# jitter draws advance the state and EVERY bounce reuses draws derived
# from the same post-jitter state.  raytpu reproduces this draw-for-draw
# in the golden renderer (rng_mode="v1_fractsin"): the float-sin chain
# is numerically fragile across compilers (1 ulp of sin -> 2.6e-3 in the
# fract), which is exactly why the production modes use the counter
# -based u32 stream above — this mode exists for reference parity only.
_FS_A = np.float32(12.9898)
_FS_B = np.float32(78.233)
_FS_M = np.float32(43758.5453)
# Cephes-style three-term pi split for the fract-sin chain's pinned
# argument reduction (args <= ~91.3 -> n <= 30, each product exact-ish)
_PI_A = np.float32(3.140625)
_PI_B = np.float32(9.6750259399414062e-4)
_PI_C = np.float32(1.2154201256553420e-10)
_INV_PI = np.float32(1.0 / np.pi)
_S1 = np.float32(-1.6666667e-1)
_S2 = np.float32(8.3333310e-3)
_S3 = np.float32(-1.9840874e-4)
_S4 = np.float32(2.7525562e-6)


def _fract(x):
    return x - jnp.floor(x)


def fs_sin(x):
    """Pinned f32 sine for the fract-sin chain (x in [0, ~92]).

    The chain multiplies sin by 43758.5453 and keeps the fraction, so a
    1-ulp sine difference moves the draw by ~2.6e-3 and the stream then
    diverges chaotically — libm sines differ by a few ulps in exactly
    this argument range (argument reduction), INCLUDING XLA's own
    scalar vs vectorized codepaths.  The reference's HLSL sin was
    GPU-implementation-defined anyway, so the spec pins ONE concrete
    sine: round-to-nearest pi-multiple reduction with a three-term pi
    split, then an odd minimax polynomial on [-pi/2, pi/2] — plain f32
    mul/add, reproducible everywhere (scalar oracle twin:
    tests/hlsl_ref.py fs_sin)."""
    n = jnp.floor(x * _INV_PI + np.float32(0.5))
    r = ((x - n * _PI_A) - n * _PI_B) - n * _PI_C
    r2 = r * r
    p = _S4
    p = p * r2 + _S3
    p = p * r2 + _S2
    p = p * r2 + _S1
    s = r + r * (r2 * p)
    # sin(n*pi + r) = (-1)^n sin(r); n is a small exact float
    sign = jnp.float32(1.0) - jnp.float32(2.0) * (n - jnp.floor(
        n * np.float32(0.5)) * np.float32(2.0))
    return s * sign


def fs_rand2d(sx, sy):
    """One rand2d draw (ref: Shader_RT.fx:106-112): advances the float2
    state x-then-y (the second sin sees the NEW x) and returns
    (value = new x, (sx', sy'))."""
    sx = _fract(fs_sin(sx * _FS_A + sy * _FS_B) * _FS_M)
    sy = _fract(fs_sin(sx * _FS_A + sy * _FS_B) * _FS_M)
    return sx, (sx, sy)


def fs_unit_sphere(sx, sy):
    """v1 random_in_unit_sphere (ref: :119-133; BY-VALUE state — the
    caller's (sx, sy) is NOT advanced): spherical draw with acos
    latitude and pow-1/3 radius."""
    r1, st = fs_rand2d(sx, sy)
    r2, st = fs_rand2d(*st)
    r3, _ = fs_rand2d(*st)
    phi = _TWO_PI * r1
    cos_t = np.float32(2.0) * r2 - np.float32(1.0)
    theta = jnp.arccos(cos_t)
    r = r3 ** np.float32(1.0 / 3.0)
    sin_t = jnp.sin(theta)
    return (r * sin_t * jnp.cos(phi), r * sin_t * jnp.sin(phi), r * cos_t)


def fs_unit_disk(sx, sy):
    """v1 random_in_unit_disk (ref: :135-144; BY-VALUE state).  The
    reference's quirk is part of the spec: x = cos(cosTheta) and
    y = cos(sinTheta) with both 'angles' uniform in [-1, 1] — the
    'disk' is a small positive square patch [cos 1, 1]^2."""
    r1, st = fs_rand2d(sx, sy)
    r2, _ = fs_rand2d(*st)
    sin_t = np.float32(2.0) * r1 - np.float32(1.0)
    cos_t = np.float32(2.0) * r2 - np.float32(1.0)
    return jnp.cos(cos_t), jnp.cos(sin_t)
