"""Pure-jnp golden renderer — the allclose oracle for every other backend.

This is the executable spec of the reference's forward rendering semantics
(ref: CSVersion/ShaderCompute.hlsl:255-315 driver loop, :155-205 intersection,
:207-252 materials; the dormant CPU skeleton Sphere.cpp:3-32 is the scalar
golden for the quadratic).  Written SoA over arbitrary pixel-array shapes in
straight-line jnp with lax.scan loops, so it is (a) trivially auditable
against the HLSL, (b) reverse-mode differentiable end-to-end, and (c) the
same code XLA compiles for the GPU as the non-Pallas path.

Reference quirks preserved (SURVEY.md quirk list — golden.py is the spec):
- metal always scatters (no "absorbed below surface" check, hlsl:219-227)
- diffuse scatter direction is normalized (hlsl:212)
- pixel jitter scaled by 1.1, divided by (dim-1) (hlsl:306-307)
- t-range (t_min, +inf) for all bounces (hlsl:262)
- depth-exhausted and scatter-fail rays return black (hlsl:274,286)
- gamma pow(1/2.2) (hlsl:99-103)
- deterministic seed from absolute pixel coords only (hlsl:295-296)
- one RNG state advance per scatter regardless of material branch
  (branch semantics; all three materials consume exactly one hashN draw);
  the RNG itself is the counter-based u32 redesign (see raytpu/rng.py)

Discrete-event gradient policy (new capability, not in the reference):
closest-hit selection, front-face sign, total-internal-reflection and the
Schlick coin flip are detached (selection masks carry no gradient); the
selected *continuous* quantities (t, normals, attenuation, directions) carry
exact gradients.  Finite-difference checks in tests/ validate this away from
visibility discontinuities.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from raytpu import rng
from raytpu.camera import Camera, get_ray
from raytpu.config import RenderConfig
from raytpu.scene import Scene

# numpy scalars, NOT jnp: creating a jnp array at import time would
# initialize the XLA backend as a side effect of `import raytpu`, which
# breaks jax.distributed.initialize() in multi-host entry points
_INF = np.float32(np.inf)
_SAFE_EPS = np.float32(1e-20)


def inv_extent(n: int) -> np.float32:
    """1 / (n - 1): the reference's jitter scale divides pixel coords by
    (dim - 1) (hlsl:306-307); a 1-pixel dimension uses 1 instead of a
    division by zero."""
    return np.float32(1.0 / max(n - 1, 1))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(_dot3(x, y, z, x, y, z), _SAFE_EPS))
    return x * inv, y * inv, z * inv


def hit_world(scene: Scene, ro, rd, t_min):
    """Closest-hit over all spheres (ref: ShaderCompute.hlsl:155-205).

    ro, rd: tuples of 3 arrays of common shape S (unnormalized direction).
    Returns (hit_any S bool, t S f32, idx S i32, normal SoA, front_face S bool).

    The reference's sequential shrinking-t_max loop is equivalent to an
    argmin over per-sphere nearest-valid roots (proof sketch: per-sphere the
    far root >= near root, so the history-dependent t_max never changes which
    root a *winning* sphere contributes; see SURVEY.md §7).  Ties go to the
    lowest index (the reference's last-wins tie rule differs only on
    measure-zero configurations).
    """
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    cx, cy, cz = scene.center[:, 0], scene.center[:, 1], scene.center[:, 2]
    rad = scene.radius

    # Broadcast pixels x spheres: shape S + (N,)
    ocx = rox[..., None] - cx
    ocy = roy[..., None] - cy
    ocz = roz[..., None] - cz
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)[..., None]
    inv_a = 1.0 / a  # one divide per pixel; roots multiply (hot loop)
    half_b = ocx * rdx[..., None] + ocy * rdy[..., None] + ocz * rdz[..., None]
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = half_b * half_b - a * c

    has_root = disc >= 0
    # Forward value: exact sqrt of the masked disc.  Gradient: from the
    # 1e-20-clamped branch — d sqrt blows up at disc == 0 (tangent ray),
    # which FMA contraction CAN hit exactly (CPU rounding rarely
    # does), turning one grazing bounce-2 hit into NaN grads for every
    # parameter.  Same straight-through guard as adjoint.py:81-84 /
    # gradkernel.py:76-79, so golden autodiff and the hand adjoints
    # agree (both give 0 at the measure-zero tangency; the silhouette
    # boundary term is handled separately by vis_w).
    sqrt_safe = jnp.sqrt(jnp.maximum(disc, 1e-20))
    sqrt_exact = jnp.sqrt(jnp.where(has_root, disc, 1.0))
    sqrtd = sqrt_safe + jax.lax.stop_gradient(sqrt_exact - sqrt_safe)
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    # accept near root if >= t_min (reference rejects root < t_min), else far
    near_ok = root1 >= t_min
    root = jnp.where(near_ok, root1, root2)
    ok = has_root & (root >= t_min)
    t_all = jnp.where(ok, root, _INF)

    t = jnp.min(t_all, axis=-1)
    idx = jnp.argmin(t_all, axis=-1).astype(jnp.int32)
    hit_any = jnp.isfinite(t)
    t = jnp.where(hit_any, t, 1.0)  # safe t for downstream math on dead lanes

    # hit point and outward normal (ref: hlsl:180-183)
    px = rox + t * rdx
    py = roy + t * rdy
    pz = roz + t * rdz
    hc = scene.center[idx]          # gather: grads flow to centers
    hr = scene.radius[idx]
    inv_r = 1.0 / jnp.where(hr == 0, 1.0, hr)
    nx = (px - hc[..., 0]) * inv_r
    ny = (py - hc[..., 1]) * inv_r
    nz = (pz - hc[..., 2]) * inv_r
    front = _dot3(rdx, rdy, rdz, nx, ny, nz) < 0
    sgn = jnp.where(front, 1.0, -1.0)
    return hit_any, t, idx, (nx * sgn, ny * sgn, nz * sgn), front


def _reflect(vx, vy, vz, nx, ny, nz):
    """v - 2*dot(v,n)*n (ref: hlsl:76-79)."""
    d = _dot3(vx, vy, vz, nx, ny, nz)
    return vx - 2 * d * nx, vy - 2 * d * ny, vz - 2 * d * nz


def _refract(ux, uy, uz, nx, ny, nz, ratio):
    """Snell refraction of a unit vector (ref: hlsl:81-88)."""
    cos_theta = jnp.minimum(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    px = ratio * (ux + cos_theta * nx)
    py = ratio * (uy + cos_theta * ny)
    pz = ratio * (uz + cos_theta * nz)
    par = -jnp.sqrt(jnp.maximum(
        jnp.abs(1.0 - _dot3(px, py, pz, px, py, pz)), _SAFE_EPS))
    return px + par * nx, py + par * ny, pz + par * nz


def _schlick(cosine, ref_idx):
    """Schlick reflectance approximation (ref: hlsl:90-97)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    return r0 + (1.0 - r0) * (m * m * m * m * m)


def scatter(scene: Scene, rd, p, normal, front, idx, seed,
            mode: str = "v2", fixed_draws=None):
    """Material scatter (ref: ShaderCompute.hlsl:207-252).

    Returns (scatter_ok, atten SoA, new_dir SoA, new_seed).  All three
    material branches are computed and selected by mask; every branch
    consumes the SAME single hash draw, so the seed advance (+0.2) is
    branch-independent — see module docstring.

    ``mode="v1"`` selects the pixel-shader generation's material
    semantics (ref: Shader_RT.fx:217-243): diffuse scatters via
    ``normal + random_in_hemisphere`` (the sphere draw flipped into the
    normal's hemisphere) with a near-zero degenerate guard and NO
    normalization; metal reflects the NORMALIZED incoming direction,
    ``saturate``s the fuzz, adds the hemisphere draw and does not
    normalize.  Dielectric and the draw count are identical in both
    generations.

    ``fixed_draws = (sx, sy, sz, h1)`` replaces the counter-based draws
    with caller-supplied values and leaves the seed untouched — the
    v1 fract-sin parity mode (rng_mode="v1_fractsin"), whose by-value
    state means every bounce of a path reuses the SAME draws.
    """
    rdx, rdy, rdz = rd
    nx, ny, nz = normal
    mat = scene.mat_type[idx]
    alb = scene.albedo[idx]
    param = scene.mat_param[idx]

    if fixed_draws is not None:
        sx, sy, sz, h1 = fixed_draws
        seed_new = seed
    else:
        (sx, sy, sz), seed_new = rng.random_in_unit_sphere(seed)
        h1, _ = rng.hash1(seed)  # same underlying draw, same new seed

    if mode == "v1":
        # hemisphere flip (Shader_RT.fx:151-163)
        flip = _dot3(sx, sy, sz, nx, ny, nz) > 0
        hxx = jnp.where(flip, sx, -sx)
        hyy = jnp.where(flip, sy, -sy)
        hzz = jnp.where(flip, sz, -sz)
        # -- v1 lambert (Shader_RT.fx:217-229): n + hemisphere, near
        # -zero guard, unnormalized
        ldx = nx + hxx
        ldy = ny + hyy
        ldz = nz + hzz
        s_eps = 1e-8
        near0 = ((jnp.abs(ldx) < s_eps) & (jnp.abs(ldy) < s_eps)
                 & (jnp.abs(ldz) < s_eps))
        ddx = jnp.where(near0, nx, ldx)
        ddy = jnp.where(near0, ny, ldy)
        ddz = jnp.where(near0, nz, ldz)
        # -- v1 metal (Shader_RT.fx:233-241): reflect(normalize(rd)) +
        # saturate(fuzz) * hemisphere, unnormalized
        u1x, u1y, u1z = _normalize3(rdx, rdy, rdz)
        rx, ry, rz = _reflect(u1x, u1y, u1z, nx, ny, nz)
        fz = jnp.clip(param, 0.0, 1.0)
        mdx = rx + fz * hxx
        mdy = ry + fz * hyy
        mdz = rz + fz * hzz
    else:
        # -- diffuse (hlsl:209-217): dir = normalize(normal + rand_sphere)
        ddx, ddy, ddz = _normalize3(nx + sx, ny + sy, nz + sz)

        # -- metal (hlsl:219-227): dir = normalize(reflect(rd, n) + fuzz*rand)
        rx, ry, rz = _reflect(rdx, rdy, rdz, nx, ny, nz)
        mdx, mdy, mdz = _normalize3(rx + param * sx, ry + param * sy,
                                    rz + param * sz)

    # -- dielectric (hlsl:229-249). Non-glass lanes get a safe IOR so the
    # unselected branch stays finite (0-fuzz metals would otherwise produce
    # inf/NaN that poison reverse-mode cotangents through the selects).
    is_glass = mat == 2
    ior = jnp.where(is_glass, jnp.maximum(param, 1e-3), 1.5)
    ux, uy, uz = _normalize3(rdx, rdy, rdz)
    ratio = jnp.where(front, 1.0 / ior, ior)
    cosine = jnp.minimum(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    sine = jnp.sqrt(jnp.maximum(1.0 - cosine * cosine, 0.0))
    cannot = ratio * sine > 1.0
    use_reflect = cannot | (_schlick(cosine, ratio) > h1)
    rfx, rfy, rfz = _reflect(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _refract(ux, uy, uz, nx, ny, nz, ratio)
    gdx = jnp.where(use_reflect, rfx, tx)
    gdy = jnp.where(use_reflect, rfy, ty)
    gdz = jnp.where(use_reflect, rfz, tz)

    is_d = mat == 0
    is_m = mat == 1
    is_g = is_glass
    ok = is_d | is_m | is_g

    atr = jnp.where(is_g, 1.0, alb[..., 0])
    atg = jnp.where(is_g, 1.0, alb[..., 1])
    atb = jnp.where(is_g, 1.0, alb[..., 2])

    ox = jnp.where(is_d, ddx, jnp.where(is_m, mdx, gdx))
    oy = jnp.where(is_d, ddy, jnp.where(is_m, mdy, gdy))
    oz = jnp.where(is_d, ddz, jnp.where(is_m, mdz, gdz))
    return ok, (atr, atg, atb), (ox, oy, oz), seed_new


def _sky(rdx, rdy, rdz):
    """Background gradient (ref: hlsl:279-283)."""
    _, uy, _ = _normalize3(rdx, rdy, rdz)
    t = 0.5 * (uy + 1.0)
    return 1.0 - 0.5 * t, 1.0 - 0.3 * t, 1.0  # lerp(white, (.5,.7,1.))


def trace(scene: Scene, ro, rd, seed, depth: int, t_min: float,
          scatter_mode: str = "v2", fixed_draws=None):
    """Iterative bounce loop (ref: sample_color, hlsl:255-287).

    SoA over pixel shape S; returns ((r,g,b), seed).  Dead lanes are masked;
    the seed only advances on live scattering lanes, matching the
    reference's early-return semantics where the inout seed stops advancing
    once a ray terminates.
    """
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    # carries derived from inputs (not fresh constants) so their device
    # -varying axes match under shard_map's varying-axis tracking
    zero = rox * 0.0
    one = zero + 1.0
    state = (
        rox, roy, roz, rdx, rdy, rdz,
        one, one, one,            # throughput
        zero, zero, zero,         # result
        zero < 1.0,               # alive (all True)
        seed,
    )

    def body(st, _):
        (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive, sd) = st
        hit_any, t, idx, normal, front = hit_world(
            scene, (ox, oy, oz), (dx, dy, dz), t_min)
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        ok, (ar, ag, ab), (sx, sy, sz), sd_new = scatter(
            scene, (dx, dy, dz), (px, py, pz), normal, front, idx, sd,
            scatter_mode, fixed_draws)

        scat = alive & hit_any & ok
        absorbed = alive & hit_any & ~ok
        missed = alive & ~hit_any

        skr, skg, skb = _sky(dx, dy, dz)
        rr = jnp.where(missed, cr * skr, rr)
        rg = jnp.where(missed, cg * skg, rg)
        rb = jnp.where(missed, cb * skb, rb)

        cr = jnp.where(scat, cr * ar, cr)
        cg = jnp.where(scat, cg * ag, cg)
        cb = jnp.where(scat, cb * ab, cb)
        ox = jnp.where(scat, px, ox)
        oy = jnp.where(scat, py, oy)
        oz = jnp.where(scat, pz, oz)
        dx = jnp.where(scat, sx, dx)
        dy = jnp.where(scat, sy, dy)
        dz = jnp.where(scat, sz, dz)
        sd = jnp.where(scat, sd_new, sd)
        alive = alive & ~(missed | absorbed)
        return (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive, sd), None

    state, _ = jax.lax.scan(body, state, None, length=depth)
    (_, _, _, _, _, _, _, _, _, rr, rg, rb, _, sd) = state
    # depth exhausted while alive -> black (rr init is already 0)
    return (rr, rg, rb), sd


def accumulate_pixels(scene: Scene, cam: Camera, cfg: RenderConfig,
                      px, py, seed, spp: int, init=None, s0: int = 0):
    """Add ``spp`` LINEAR samples per pixel starting from carried RNG state.

    Returns ((sum_r, sum_g, sum_b), seed').  This is the real carried
    -state version of the reference's dead progressive-accumulation
    scaffolding (currSamples uploaded but never read —
    CSVersion/DxCSApp.cpp:186,491-492, ShaderCompute.hlsl:7): rendering
    K batches of spp/K samples, threading ``seed`` AND the running sums
    (``init``), is bit-identical to one spp-sample render — the f32
    addition chain is sample-by-sample in both cases.

    In the "parallel" RNG mode, ``seed`` is the per-pixel BASE state and
    ``s0`` the global index of the first sample in this batch (each
    sample's stream is ``fold_in(seed, s0 + i)``); the returned seed is
    the unchanged base.
    """
    fx = px.astype(jnp.float32)
    fy = py.astype(jnp.float32)
    inv_w = inv_extent(cfg.width)
    inv_h = inv_extent(cfg.height)
    # input-derived (see trace() varying-axis note); dtype follows the
    # scene so an f64 scene yields an f64 carry (the f64-ground-truth
    # ground truth for gradient checks — f32 scenes are unchanged)
    zero = (fx * 0.0).astype(scene.center.dtype)
    if init is None:
        init = (zero, zero, zero)
    parallel = cfg.rng_mode == "parallel"

    if cfg.rng_mode == "v1_fractsin":
        # v1 pixel-shader parity mode (ref: Shader_RT.fx:419-455 PS_Main
        # + :288-298 get_ray + :106-163 RNG): the float2 state starts at
        # the pixel's texcoord and ONLY the two jitter draws advance it —
        # the lens offset and every bounce's scatter/Schlick draws derive
        # BY VALUE from the same post-jitter state (the reference's
        # by-value randState defect, reproduced draw-for-draw).  The
        # u32 ``seed`` is passed through untouched.
        if cfg.scatter_mode != "v1":
            raise ValueError(
                "rng_mode='v1_fractsin' is the v1 generation's RNG; "
                "pair it with scatter_mode='v1'")
        w_f = jnp.float32(cfg.width)
        h_f = jnp.float32(cfg.height)
        half = jnp.float32(0.5)
        # texcoord at pixel centers (the fullscreen-quad interpolant,
        # ref: :422 randState = frag.tex0)
        sx0 = (fx + half) / w_f
        sy0 = (fy + half) / h_f
        # batched accumulation: the float2 state is not part of the
        # carried u32 seed, so FAST-FORWARD the 2 jitter advances of
        # the s0 samples already rendered — batch-of-batches stays
        # draw-identical to a one-shot render (s0 may be traced; the
        # loop is 0-trip for a plain full render)
        def ff(_, st):
            _, st = rng.fs_rand2d(*st)
            _, st = rng.fs_rand2d(*st)
            return st

        sx0, sy0 = jax.lax.fori_loop(
            0, jnp.asarray(s0).astype(jnp.int32), ff, (sx0, sy0))

        def sample_fs(carry, _):
            acc_r, acc_g, acc_b, sx, sy = carry
            j1, (sx, sy) = rng.fs_rand2d(sx, sy)
            j2, (sx, sy) = rng.fs_rand2d(sx, sy)
            # u = ((tex.x * W) + r) / W (ref: :433-434 — jitter over W,
            # not the v2 generation's 1.1 / (W - 1))
            u = (fx + half + j1) / w_f
            v = (fy + half + j2) / h_f
            ldx, ldy = rng.fs_unit_disk(sx, sy)          # by value
            lr = cam.lens_radius
            ox = cam.origin[0] + lr * (ldx * cam.u[0] + ldy * cam.v[0])
            oy = cam.origin[1] + lr * (ldx * cam.u[1] + ldy * cam.v[1])
            oz = cam.origin[2] + lr * (ldx * cam.u[2] + ldy * cam.v[2])
            rdx = (cam.lower_left[0] + u * cam.horizontal[0]
                   + v * cam.vertical[0] - ox)
            rdy = (cam.lower_left[1] + u * cam.horizontal[1]
                   + v * cam.vertical[1] - oy)
            rdz = (cam.lower_left[2] + u * cam.horizontal[2]
                   + v * cam.vertical[2] - oz)
            s3 = rng.fs_unit_sphere(sx, sy)              # by value
            h1, _ = rng.fs_rand2d(sx, sy)                # by value
            (r, g, b), _ = trace(
                scene, (ox, oy, oz), (rdx, rdy, rdz), seed, cfg.depth,
                cfg.t_min, cfg.scatter_mode,
                fixed_draws=(s3[0], s3[1], s3[2], h1))
            return (acc_r + r, acc_g + g, acc_b + b, sx, sy), None

        (acc_r, acc_g, acc_b, _, _), _ = jax.lax.scan(
            sample_fs, (*init, sx0, sy0), None, length=spp)
        return (acc_r, acc_g, acc_b), seed

    def one_sample(sd):
        (j1a, _), sd = rng.hash2(sd)
        (_, j2b), sd = rng.hash2(sd)
        u = (fx + j1a * 1.1) * inv_w
        v = (fy + j2b * 1.1) * inv_h
        ro, rd, sd = get_ray(cam, u, v, sd)
        return trace(scene, ro, rd, sd, cfg.depth, cfg.t_min,
                     cfg.scatter_mode)

    def sample(carry, s):
        acc_r, acc_g, acc_b, sd = carry
        if parallel:
            # independent per-(pixel, sample) stream: ``seed`` is the
            # base (pixel seed + sample offset rides in s)
            (r, g, b), _ = one_sample(rng.fold_in(sd, s))
            sd_next = sd
        else:
            (r, g, b), sd_next = one_sample(sd)
        return (acc_r + r, acc_g + g, acc_b + b, sd_next), None

    (acc_r, acc_g, acc_b, seed), _ = jax.lax.scan(
        sample, (*init, seed),
        jnp.arange(spp, dtype=jnp.uint32) + jnp.uint32(s0))
    return (acc_r, acc_g, acc_b), seed


def render_pixels(scene: Scene, cam: Camera, cfg: RenderConfig, px, py):
    """Render a flat SoA batch of pixels; returns (r, g, b) arrays.

    px, py: i32 arrays of pixel coordinates (x = column, y = row;
    row 0 is the BOTTOM of the image, i.e. v = y/(H-1), matching the
    reference's UAV/texcoord convention — ShaderCompute.hlsl:306-307).
    """
    seed = rng.pixel_seed(px.astype(jnp.uint32), py.astype(jnp.uint32))
    (acc_r, acc_g, acc_b), _ = accumulate_pixels(
        scene, cam, cfg, px, py, seed, cfg.spp)
    inv_spp = jnp.float32(1.0 / cfg.spp)
    return _to_gamma(acc_r * inv_spp, cfg.gamma), \
        _to_gamma(acc_g * inv_spp, cfg.gamma), \
        _to_gamma(acc_b * inv_spp, cfg.gamma)


def _to_gamma(x, gamma):
    """pow(x, 1/gamma) with a zero-safe gradient (ref toGamma hlsl:99-103)."""
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, jnp.exp(jnp.log(safe) / gamma), 0.0)


def render_flat(scene: Scene, cam: Camera, cfg: RenderConfig, px, py):
    """Render a flat pixel-id batch, chunked -> (n, 3) f32 colors.

    Chunked over pixels with lax.map to bound the (pixels x spheres)
    broadcast memory; each chunk is rematerialized (jax.checkpoint) so
    jax.grad of a loss over the full image stays within memory.  The batch
    length must be a multiple of min(cfg.chunk_pixels, len) — callers pad
    (RNG seeds depend only on absolute pixel coords, so duplicated pad
    pixels render identically and are sliced away harmlessly).
    """
    n = px.shape[0]
    chunk = min(cfg.chunk_pixels, n)

    @jax.checkpoint
    def do_chunk(xy):
        r, g, b = render_pixels(scene, cam, cfg, xy[0], xy[1])
        return jnp.stack([r, g, b], axis=-1)

    chunks = jax.lax.map(
        do_chunk,
        (px.reshape(-1, chunk), py.reshape(-1, chunk)),
    )
    return chunks.reshape(-1, 3)


@functools.partial(jax.jit, static_argnums=(2,))
def render_golden(scene: Scene, cam: Camera, cfg: RenderConfig):
    """Full-frame golden render -> (H, W, 3) f32 image in [0, 1]."""
    h, w = cfg.height, cfg.width
    n = h * w
    chunk = min(cfg.chunk_pixels, n)
    pad = (-n) % chunk
    flat = jnp.arange(n + pad, dtype=jnp.int32)
    px = flat % w
    py = jnp.minimum(flat // w, h - 1)  # pad pixels render row h-1 harmlessly
    return render_flat(scene, cam, cfg, px, py)[:n].reshape(h, w, 3)
