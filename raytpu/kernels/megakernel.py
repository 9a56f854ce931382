"""Pallas-Triton path-tracing engine: the GPU forward.

The reference's compute-shader kernel (ref: CSVersion/ShaderCompute.hlsl
:289-315 CSMain driver, :255-287 bounce loop, :155-205 intersection,
:207-252 materials) as ONE Triton kernel (``pl.pallas_call(...,
backend="triton")``):

- one program per power-of-two block of ray lanes, one lane per pixel
  of a row slab; the grid has far more programs than the card has SMs,
  blocks run in any order and nothing carries over between them;
- a lane holds its ray's whole spp x depth life in registers: no ray
  state goes back to device memory between bounces, and the frame is
  one launch instead of a scan of per-bounce launches;
- the sample loop is the PERSISTENT-REFILL state machine: the moment a
  lane's sample terminates (miss, absorb, depth cap) it spawns its
  pixel's next sample, so dead lanes do not run empty bounces; a block
  exits when every lane has spent its spp budget;
- closest hit is a brute-force sweep over the scene, read as scalars
  from global memory (it stays in L1/L2: 64 bytes a sphere), carrying
  only (t, winner index); the winner's attributes are gathered once per
  bounce;
- RNG is the counter-based u32 stream of raytpu/rng.py, seeded from
  absolute pixel coordinates, so a slab or a block renders the same
  pixels as the whole frame.

The math is golden.py's, op for op: interpret-mode renders are
bit-identical to :func:`raytpu.golden.render_golden`.  Compiled on the
card, Triton's f32 division (``div.full``), libdevice transcendentals
and FMA contraction differ from XLA's in the last bits, which moves a
few paths onto other branches; chip_smoke.py states the tolerance.

Differentiation: :func:`render_pallas` carries a ``jax.custom_vjp``
whose backward is the XLA adjoint's VJP (raytpu/adjoint.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from raytpu import rng
from raytpu.camera import Camera
from raytpu.config import RenderConfig
from raytpu.golden import inv_extent
from raytpu.scene import Scene

# ray lanes per program: one warp, one lane per thread.  A block runs
# until its slowest lane has spent its spp budget, so narrow blocks
# waste less on divergent path lengths.  On an H100 80GB HBM3 (700 W),
# 32 lanes against 64: config 4 @ 20 spp 17.5 vs 19.5 ms, REFERENCE_V2
# 67.6 vs 75.1 ms, config 2 0.49 vs 0.43 ms
BLOCK = 32
_MIN_BLOCK = 16
_MAX_WARPS = 4
# floats per sphere in the scene pack: cx cy cz r mat ar ag ab param
_STRIDE = 16
_N_CAM = 32
_INF = np.float32(np.inf)
_SAFE_EPS = np.float32(1e-20)


def block_lanes(n_pixels: int, block: int | None = None) -> int:
    """Lanes per program for a slab of ``n_pixels``: ``block`` (default
    :data:`BLOCK`), shrunk to the slab's size rounded up to a power of
    two, never below 16."""
    b = BLOCK if block is None else int(block)
    if b < 1 or b & (b - 1):
        raise ValueError(f"block must be a power of two, got {b}")
    fit = 1 << max(0, int(n_pixels) - 1).bit_length()
    return max(_MIN_BLOCK, min(b, fit))


def num_warps(block: int) -> int:
    return max(1, min(_MAX_WARPS, block // 32))


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(_dot3(x, y, z, x, y, z), _SAFE_EPS))
    return x * inv, y * inv, z * inv


def _reflect(vx, vy, vz, nx, ny, nz):
    d = _dot3(vx, vy, vz, nx, ny, nz)
    return vx - 2 * d * nx, vy - 2 * d * ny, vz - 2 * d * nz


def _refract(ux, uy, uz, nx, ny, nz, ratio):
    cos_theta = jnp.minimum(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    px = ratio * (ux + cos_theta * nx)
    py = ratio * (uy + cos_theta * ny)
    pz = ratio * (uz + cos_theta * nz)
    par = -jnp.sqrt(jnp.maximum(
        jnp.abs(1.0 - _dot3(px, py, pz, px, py, pz)), _SAFE_EPS))
    return px + par * nx, py + par * ny, pz + par * nz


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    return r0 + (1.0 - r0) * (m * m * m * m * m)


def _sky(rdx, rdy, rdz):
    _, uy, _ = _normalize3(rdx, rdy, rdz)
    t = 0.5 * (uy + 1.0)
    return 1.0 - 0.5 * t, 1.0 - 0.3 * t, jnp.ones_like(t)


def _to_gamma(x, gamma):
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, jnp.exp(jnp.log(safe) / gamma), 0.0)


def _make_bounce(sc_ref, n_spheres: int, t_min, scatter_mode: str):
    """One bounce of golden.trace's masked step over a block of lanes:
    ``bounce(state) -> state`` with state
    ``(ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive_f, sd)``."""

    def attr(idx, k):
        return sc_ref[idx * _STRIDE + k]

    def bounce(st):
        (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive_f, sd) = st
        alive = alive_f > 0
        a = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a
        neg_inv_a = -inv_a

        # closest hit (hlsl:188-205, golden.hit_world).  disc < 0 gives
        # a NaN root whose compares are all false, so ``win`` stays
        # false: the same winner as golden's has_root select.  Strict <
        # keeps the lowest index on ties, as golden's argmin does.
        def sphere(j, carry):
            tb, wi = carry
            s_cx = attr(j, 0)
            s_cy = attr(j, 1)
            s_cz = attr(j, 2)
            s_rad = attr(j, 3)
            ocx = ox - s_cx
            ocy = oy - s_cy
            ocz = oz - s_cz
            half_b = ocx * dx + ocy * dy + ocz * dz
            c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - s_rad * s_rad
            disc = half_b * half_b - a * c
            sqrtd = jnp.sqrt(disc)
            root1 = (half_b + sqrtd) * neg_inv_a
            root2 = (sqrtd - half_b) * inv_a
            root = jnp.where(root1 >= t_min, root1, root2)
            win = (root >= t_min) & (root < tb)
            return jnp.where(win, root, tb), jnp.where(win, j, wi)

        tb, wi = jax.lax.fori_loop(
            0, n_spheres, sphere,
            (jnp.full(ox.shape, _INF), jnp.full(ox.shape, -1, jnp.int32)))
        hit_any = tb < _INF
        t = jnp.where(hit_any, tb, 1.0)
        # misses read sphere 0, as golden's argmin over an all-inf row;
        # nothing of a miss lane's hit record reaches its state
        wi = jnp.maximum(wi, 0)
        h_cx, h_cy, h_cz, h_rad = (attr(wi, k) for k in range(4))
        h_mt, h_ar, h_ag, h_ab, h_mp = (attr(wi, k) for k in range(4, 9))

        hpx = ox + t * dx
        hpy = oy + t * dy
        hpz = oz + t * dz
        inv_r = 1.0 / jnp.where(h_rad == 0, 1.0, h_rad)
        nx = (hpx - h_cx) * inv_r
        ny = (hpy - h_cy) * inv_r
        nz = (hpz - h_cz) * inv_r
        front = _dot3(dx, dy, dz, nx, ny, nz) < 0
        sgn = jnp.where(front, 1.0, -1.0)
        nx = nx * sgn
        ny = ny * sgn
        nz = nz * sgn

        # scatter (hlsl:207-252, golden.scatter)
        (sx, sy, sz), sd_new = rng.random_in_unit_sphere(sd)
        h1, _ = rng.hash1(sd)
        if scatter_mode == "v1":
            flip = _dot3(sx, sy, sz, nx, ny, nz) > 0
            hxx = jnp.where(flip, sx, -sx)
            hyy = jnp.where(flip, sy, -sy)
            hzz = jnp.where(flip, sz, -sz)
            ldx = nx + hxx
            ldy = ny + hyy
            ldz = nz + hzz
            s_eps = 1e-8
            near0 = ((jnp.abs(ldx) < s_eps) & (jnp.abs(ldy) < s_eps)
                     & (jnp.abs(ldz) < s_eps))
            ddx = jnp.where(near0, nx, ldx)
            ddy = jnp.where(near0, ny, ldy)
            ddz = jnp.where(near0, nz, ldz)
            u1x, u1y, u1z = _normalize3(dx, dy, dz)
            rx, ry, rz = _reflect(u1x, u1y, u1z, nx, ny, nz)
            fz = jnp.clip(h_mp, 0.0, 1.0)
            mdx = rx + fz * hxx
            mdy = ry + fz * hyy
            mdz = rz + fz * hzz
        else:
            ddx, ddy, ddz = _normalize3(nx + sx, ny + sy, nz + sz)
            rx, ry, rz = _reflect(dx, dy, dz, nx, ny, nz)
            mdx, mdy, mdz = _normalize3(
                rx + h_mp * sx, ry + h_mp * sy, rz + h_mp * sz)

        is_glass = h_mt == 2.0
        ior = jnp.where(is_glass, jnp.maximum(h_mp, 1e-3), 1.5)
        ux, uy, uz = _normalize3(dx, dy, dz)
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

        is_d = h_mt == 0.0
        is_m = h_mt == 1.0
        ok = is_d | is_m | is_glass
        atr = jnp.where(is_glass, 1.0, h_ar)
        atg = jnp.where(is_glass, 1.0, h_ag)
        atb = jnp.where(is_glass, 1.0, h_ab)
        odx = jnp.where(is_d, ddx, jnp.where(is_m, mdx, gdx))
        ody = jnp.where(is_d, ddy, jnp.where(is_m, mdy, gdy))
        odz = jnp.where(is_d, ddz, jnp.where(is_m, mdz, gdz))

        scat = alive & hit_any & ok
        absorbed = alive & hit_any & ~ok
        missed = alive & ~hit_any
        # ADD, not overwrite: a sample misses at most once, starting
        # from rr = 0, so this equals golden's overwrite
        skr, skg, skb = _sky(dx, dy, dz)
        rr = jnp.where(missed, rr + cr * skr, rr)
        rg = jnp.where(missed, rg + cg * skg, rg)
        rb = jnp.where(missed, rb + cb * skb, rb)
        cr = jnp.where(scat, cr * atr, cr)
        cg = jnp.where(scat, cg * atg, cg)
        cb = jnp.where(scat, cb * atb, cb)
        ox = jnp.where(scat, hpx, ox)
        oy = jnp.where(scat, hpy, oy)
        oz = jnp.where(scat, hpz, oz)
        dx = jnp.where(scat, odx, dx)
        dy = jnp.where(scat, ody, dy)
        dz = jnp.where(scat, odz, dz)
        sd = jnp.where(scat, sd_new, sd)
        alive = alive & ~(missed | absorbed)
        alive_f = jnp.where(alive, 1.0, 0.0)
        return (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive_f, sd)

    return bounce


def _make_gen_ray(cam_ref, fx, fy, inv_w, inv_h):
    """Jitter + raygen -> ``gen_ray(sd) -> (ox, oy, oz, dx, dy, dz, sd')``:
    golden.accumulate_pixels' jitter and camera.get_ray, op for op."""
    c_ox, c_oy, c_oz = cam_ref[0], cam_ref[1], cam_ref[2]
    c_hx, c_hy, c_hz = cam_ref[3], cam_ref[4], cam_ref[5]
    c_vx, c_vy, c_vz = cam_ref[6], cam_ref[7], cam_ref[8]
    c_lx, c_ly, c_lz = cam_ref[9], cam_ref[10], cam_ref[11]
    c_ux, c_uy, c_uz = cam_ref[12], cam_ref[13], cam_ref[14]
    c_wx, c_wy, c_wz = cam_ref[15], cam_ref[16], cam_ref[17]
    lens_r = cam_ref[18]
    defocus = lens_r > 0

    def gen_ray(sd):
        (j1a, _), sd = rng.hash2(sd)
        (_, j2b), sd = rng.hash2(sd)
        u = (fx + j1a * 1.1) * inv_w
        v = (fy + j2b * 1.1) * inv_h
        (ldx, ldy), sd_lens = rng.random_in_unit_disk(sd)
        sd = jnp.where(defocus, sd_lens, sd)
        rdx_l = lens_r * ldx
        rdy_l = lens_r * ldy
        offx = jnp.where(defocus, c_ux * rdx_l + c_wx * rdy_l, 0.0)
        offy = jnp.where(defocus, c_uy * rdx_l + c_wy * rdy_l, 0.0)
        offz = jnp.where(defocus, c_uz * rdx_l + c_wz * rdy_l, 0.0)
        ox = c_ox + offx
        oy = c_oy + offy
        oz = c_oz + offz
        dx = c_lx + u * c_hx + v * c_vx - ox
        dy = c_ly + u * c_hy + v * c_vy - oy
        dz = c_lz + u * c_hz + v * c_vz - oz
        return ox, oy, oz, dx, dy, dz, sd

    return gen_ray


@functools.lru_cache(maxsize=64)
def _make_kernel(cfg: RenderConfig, n_spheres: int, n_pixels: int,
                 block: int, spp: int, carry_state: bool):
    """Kernel over one block of ``block`` lanes of a row slab of
    ``n_pixels`` = rows x width pixels.  Operands: ints (8,) i32
    [row0, s0], camera (32,) f32, scene (N*16,) f32; with
    ``carry_state`` also the carried linear sums and seeds, and the
    outputs are sums + seeds instead of gamma-corrected colors."""
    width = cfg.width
    parallel = cfg.rng_mode == "parallel"
    t_min = np.float32(cfg.t_min)
    inv_w = inv_extent(cfg.width)
    inv_h = inv_extent(cfg.height)
    inv_spp = np.float32(1.0 / spp)
    depth_f = np.float32(cfg.depth)
    spp_f = np.float32(spp)
    gamma = cfg.gamma

    def kernel(ints_ref, cam_ref, sc_ref, *rest):
        if carry_state:
            (acr_ref, acg_ref, acb_ref, sin_ref,
             r_ref, g_ref, b_ref, sout_ref) = rest
        else:
            r_ref, g_ref, b_ref = rest
        row0 = ints_ref[0]
        s0 = ints_ref[1].astype(jnp.uint32)
        p = (pl.program_id(0) * block
             + jax.lax.broadcasted_iota(jnp.int32, (block,), 0))
        px = p % width
        py = row0 + p // width
        fx = px.astype(jnp.float32)
        fy = py.astype(jnp.float32)
        one = jnp.ones((block,), jnp.float32)
        zero = jnp.zeros((block,), jnp.float32)
        # padded lanes past the slab start dead: they never run a bounce
        live0 = jnp.where(p < n_pixels, 1.0, 0.0)

        seed0 = rng.pixel_seed(px.astype(jnp.uint32), py.astype(jnp.uint32))
        if carry_state:
            acc0 = (acr_ref[...], acg_ref[...], acb_ref[...])
            if not parallel:
                # sequential progressive: resume each pixel's chain
                seed0 = sin_ref[...]
        else:
            acc0 = (zero, zero, zero)

        bounce = _make_bounce(sc_ref, n_spheres, t_min, cfg.scatter_mode)
        gen_ray = _make_gen_ray(cam_ref, fx, fy, inv_w, inv_h)

        def step(st):
            (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb,
             alive_f, sd, s_pl, d_pl, ar, ag, ab) = st
            was = alive_f > 0
            (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb,
             alive_f, sd) = bounce((ox, oy, oz, dx, dy, dz, cr, cg, cb,
                                    rr, rg, rb, alive_f, sd))
            d_pl = jnp.where(was, d_pl + 1.0, d_pl)
            fin = was & ((alive_f <= 0) | (d_pl >= depth_f))
            s_next = s_pl + 1.0
            more = fin & (s_next < spp_f)
            ar = jnp.where(fin, ar + rr, ar)
            ag = jnp.where(fin, ag + rg, ag)
            ab = jnp.where(fin, ab + rb, ab)
            if parallel:
                # per-sample stream, re-folded from the pixel seed
                sd_r = rng.fold_in(
                    seed0, s_next.astype(jnp.int32).astype(jnp.uint32) + s0)
            else:
                # the sequential chain continues from the lane's seed
                sd_r = sd
            nox, noy, noz, ndx, ndy, ndz, sd_n = gen_ray(sd_r)
            ox = jnp.where(more, nox, ox)
            oy = jnp.where(more, noy, oy)
            oz = jnp.where(more, noz, oz)
            dx = jnp.where(more, ndx, dx)
            dy = jnp.where(more, ndy, dy)
            dz = jnp.where(more, ndz, dz)
            cr = jnp.where(more, 1.0, cr)
            cg = jnp.where(more, 1.0, cg)
            cb = jnp.where(more, 1.0, cb)
            rr = jnp.where(fin, 0.0, rr)
            rg = jnp.where(fin, 0.0, rg)
            rb = jnp.where(fin, 0.0, rb)
            sd = jnp.where(more, sd_n, sd)
            s_pl = jnp.where(fin, s_next, s_pl)
            d_pl = jnp.where(more, 0.0, d_pl)
            alive_f = jnp.where(fin, jnp.where(more, 1.0, 0.0), alive_f)
            return (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb,
                    alive_f, sd, s_pl, d_pl, ar, ag, ab)

        sd_init = rng.fold_in(seed0, s0) if parallel else seed0
        iox, ioy, ioz, idx_, idy, idz, sd_i = gen_ray(sd_init)
        st = (iox, ioy, ioz, idx_, idy, idz, one, one, one,
              zero, zero, zero, live0, sd_i, zero, zero, *acc0)
        st = jax.lax.while_loop(lambda s: jnp.max(s[12]) > 0, step, st)
        acc_r, acc_g, acc_b = st[16], st[17], st[18]
        if carry_state:
            r_ref[...] = acc_r
            g_ref[...] = acc_g
            b_ref[...] = acc_b
            # parallel streams re-fold per sample: the pixel seed is
            # the carried state; sequential carries the chain
            sout_ref[...] = seed0 if parallel else st[13]
        else:
            r_ref[...] = _to_gamma(acc_r * inv_spp, gamma)
            g_ref[...] = _to_gamma(acc_g * inv_spp, gamma)
            b_ref[...] = _to_gamma(acc_b * inv_spp, gamma)

    return kernel


def pack_camera(cam: Camera) -> jnp.ndarray:
    """(32,) f32: origin, horizontal, vertical, lower_left, u, v,
    lens_radius, zero padding."""
    return jnp.concatenate([
        cam.origin, cam.horizontal, cam.vertical, cam.lower_left,
        cam.u, cam.v, jnp.reshape(cam.lens_radius, (1,)),
        jnp.zeros((_N_CAM - 19,), jnp.float32),
    ]).astype(jnp.float32)


def pack_scene(scene: Scene) -> jnp.ndarray:
    """(N * 16,) f32, sphere-major: cx, cy, cz, r, mat_type, ar, ag,
    ab, mat_param, zero padding."""
    cols = jnp.stack([
        scene.center[:, 0], scene.center[:, 1], scene.center[:, 2],
        scene.radius, scene.mat_type.astype(jnp.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.mat_param,
    ], axis=-1).astype(jnp.float32)
    return jnp.pad(cols, ((0, 0), (0, _STRIDE - 9))).reshape(-1)


def _run(scene: Scene, cam: Camera, cfg: RenderConfig, interpret: bool,
         row0=0, rows=None, block=None, s0=0, spp=None, carry=None):
    """Run the engine over rows [row0, row0 + rows) of the cfg frame ->
    three flat (n_pad,) planes (and seeds with ``carry``)."""
    if cfg.rng_mode not in ("sequential", "parallel"):
        raise ValueError(f"the engine has no rng_mode {cfg.rng_mode!r}; "
                         "the v1 fract-sin parity mode is golden-only")
    rows = cfg.height if rows is None else int(rows)
    spp = cfg.spp if spp is None else int(spp)
    n_pix = rows * cfg.width
    blk = block_lanes(n_pix, block)
    n_pad = -(-n_pix // blk) * blk
    kernel = _make_kernel(cfg, scene.count, n_pix, blk, spp,
                          carry is not None)
    ints = jnp.zeros((8,), jnp.int32).at[0].set(
        jnp.asarray(row0, jnp.int32)).at[1].set(
        jnp.asarray(s0).astype(jnp.int32))
    sc = pack_scene(scene)
    operands = [ints, pack_camera(cam), sc]
    whole = [pl.BlockSpec(x.shape, lambda i: (0,)) for x in operands]
    plane = pl.BlockSpec((blk,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    out_shape = [f32, f32, f32]
    if carry is not None:
        operands += [jnp.pad(x.reshape(-1), (0, n_pad - n_pix))
                     for x in carry]
        whole += [plane] * 4
        out_shape.append(jax.ShapeDtypeStruct((n_pad,), jnp.uint32))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // blk,),
        in_specs=whole,
        out_specs=[plane] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps(blk),
                                           num_stages=1),
        interpret=interpret,
        name="raytpu_engine",
    )(*operands)


def render_rows(scene: Scene, cam: Camera, cfg: RenderConfig, row0,
                rows: int, interpret: bool = False,
                block: int | None = None) -> jnp.ndarray:
    """Rows [row0, row0 + rows) of the cfg frame -> (rows, W, 3) image.
    ``row0`` may be traced, so one compiled kernel serves every slab of
    a sharded frame; rows past the frame render harmlessly (their seeds
    are absolute-coordinate)."""
    r, g, b = _run(scene, cam, cfg, interpret, row0=row0, rows=rows,
                   block=block)
    n = rows * cfg.width
    return jnp.stack([r[:n], g[:n], b[:n]], axis=-1).reshape(
        rows, cfg.width, 3)


def _adjoint_bwd(cfg, vis_w, res, ct):
    from raytpu import adjoint
    scene, cam = res
    _, vjp = jax.vjp(
        lambda s, c: adjoint.render_golden_adjoint(s, c, cfg, vis_w),
        scene, cam)
    ds, dc = vjp(ct)
    return ds._replace(mat_type=None), dc


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def _render(scene, cam, cfg, interpret, block, vis_w):
    return render_rows(scene, cam, cfg, 0, cfg.height, interpret, block)


def _render_fwd(scene, cam, cfg, interpret, block, vis_w):
    return _render(scene, cam, cfg, interpret, block, vis_w), (scene, cam)


def _render_bwd(cfg, interpret, block, vis_w, res, ct):
    return _adjoint_bwd(cfg, vis_w, res, ct)


_render.defvjp(_render_fwd, _render_bwd)
_render_jit = jax.jit(_render, static_argnums=(2, 3, 4, 5))


def render_pallas(scene: Scene, cam: Camera, cfg: RenderConfig,
                  interpret: bool = False, block: int | None = None,
                  vis_w: float = 0.0) -> jnp.ndarray:
    """Full-frame engine render -> (H, W, 3) f32 image in [0, 1].

    Compiles for the GPU; ``interpret=True`` runs the same kernel in the
    Pallas interpreter (CPU tests).  ``block`` sets the lanes per
    program (see :func:`block_lanes`); images are identical for every
    block.  Under ``jax.grad`` the backward is the XLA adjoint's VJP;
    ``vis_w > 0`` adds its silhouette gradients (forward unchanged)."""
    return _render_jit(scene, cam, cfg, bool(interpret), block,
                       float(vis_w))


@functools.partial(jax.jit, static_argnums=(2, 6, 7, 9))
def accumulate_pallas(scene: Scene, cam: Camera, cfg: RenderConfig,
                      acc, seed, samples0, spp: int,
                      interpret: bool = False, row0=0, rows=None):
    """One progressive batch -> (acc', seed'): add ``spp`` samples to
    the carried (rows, W, 3) linear sums ``acc`` and (rows, W) u32
    seeds (raytpu/progressive.py).  Sequential RNG resumes each pixel's
    chain; parallel RNG folds global sample indices from ``samples0``
    and passes the seeds through.  ``row0``/``rows`` select a row slab
    (``row0`` may be traced)."""
    rows = cfg.height if rows is None else rows
    acc = jnp.asarray(acc, jnp.float32)
    carry = (acc[..., 0], acc[..., 1], acc[..., 2],
             jnp.asarray(seed, jnp.uint32))
    r, g, b, sd = _run(scene, cam, cfg, interpret, row0=row0, rows=rows,
                       s0=samples0, spp=spp, carry=carry)
    n = rows * cfg.width
    acc_new = jnp.stack([r[:n], g[:n], b[:n]], axis=-1).reshape(
        rows, cfg.width, 3)
    return acc_new, sd[:n].reshape(rows, cfg.width)
