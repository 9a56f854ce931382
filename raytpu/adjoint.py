"""Hand-structured adjoint of the bounce loop (SURVEY.md §7 stage 4).

Generic reverse-mode over :func:`raytpu.golden.trace` differentiates the
whole ``hit_world`` broadcast: the backward of every bounce re-materializes
a (pixels x spheres) intersection sweep just to pull gradients through the
argmin gather.  But the derivative of a bounce only involves the ONE
sphere the ray actually hit — the closest-hit *selection* is discrete and
detached by policy (golden.py docstring).

So the custom VJP here:

- **forward** runs the plain bounce loop, additionally saving per bounce a
  compact residual: the incoming ray/throughput state, the winning sphere
  index, the event masks (scat/missed), and the RNG state (all O(pixels x
  depth), no sphere dimension);
- **backward** is a reverse ``lax.scan`` that, per bounce, re-derives the
  continuous math of ``bounce_step`` against ONLY the gathered sphere
  (jax.vjp of a small closed function) and scatter-adds the sphere-param
  cotangents at the stored index.

Cost: O(P * depth) backward instead of O(P * depth * N) — the win scales
with scene size; gradients are IDENTICAL (same detach policy, same
continuous math) to ``jax.grad`` of the golden renderer up to f32
reassociation.

The RNG draws are recomputed from the stored pre-bounce state (counter
-based streams make this free), so no random vectors are stored.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytpu import rng
from raytpu.camera import Camera, get_ray
from raytpu.config import RenderConfig
from raytpu.scene import Scene
from raytpu.golden import (
    _dot3, _normalize3, _reflect, _refract, _schlick, _sky, _to_gamma,
    hit_world, inv_extent, _INF,
)


def segment_sum(idx, vals, n: int):
    """Per-sphere sums of per-ray rows: ``vals`` (P, k) added at the
    sphere index ``idx`` (any shape, P elements) -> (n, k).  XLA lowers
    the scatter-add to atomics on the GPU."""
    return jax.ops.segment_sum(vals, idx.reshape(-1), num_segments=n)


def _gather_leaves(scene: Scene, idx):
    return (scene.center[idx], scene.radius[idx], scene.albedo[idx],
            scene.mat_param[idx])


def _bounce_math(ro, rd, thr, gathered, mat, seed, masks, t_min,
                 scatter_mode: str = "v2"):
    """Continuous per-bounce math against the ONE gathered sphere.

    ro/rd/thr: incoming ray origin/direction/throughput (SoA tuples).
    gathered: (center (...,3), radius, albedo (...,3), mat_param) of the
    winning sphere (already gathered — gradients flow to these).
    mat: i32 material type of the winner (discrete, no grad).
    masks: (scat, missed) booleans — the detached discrete events.
    Returns (new ro, new rd, new thr, radiance contribution) —
    exactly golden.trace's body with the argmin/gather replaced by the
    pre-selected sphere.
    """
    ox, oy, oz = ro
    dx, dy, dz = rd
    cr, cg, cb = thr
    center, radius, albedo, param = gathered
    scat, missed = masks

    # recompute t for the selected sphere (hlsl:155-186 quadratic,
    # near-root selection re-derived; root CHOICE rides the sign bits of
    # the same continuous quantities, matching hit_world's selection)
    cx, cy, cz_ = center[..., 0], center[..., 1], center[..., 2]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz_
    a = _dot3(dx, dy, dz, dx, dy, dz)
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - radius * radius
    disc = half_b * half_b - a * c
    # value: EXACTLY hit_world's select (bit-parity with the oracle);
    # gradient: from the 1e-20-clamped branch (d sqrt blows up at 0)
    sqrt_safe = jnp.sqrt(jnp.maximum(disc, 1e-20))
    sqrt_exact = jnp.sqrt(jnp.where(disc >= 0, disc, 1.0))
    sqrtd = sqrt_safe + jax.lax.stop_gradient(sqrt_exact - sqrt_safe)
    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    near_ok = jax.lax.stop_gradient(root1 >= t_min)
    t = jnp.where(near_ok, root1, root2)
    t = jnp.where(jax.lax.stop_gradient(scat), t, 1.0)  # dead lanes: safe t

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    inv_r = 1.0 / jnp.where(radius == 0, 1.0, radius)
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    nz = (pz - cz_) * inv_r
    front = jax.lax.stop_gradient(_dot3(dx, dy, dz, nx, ny, nz) < 0)
    sgn = jnp.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    # scatter draws recomputed from the stored pre-bounce RNG state
    (sx, sy, sz), _ = rng.random_in_unit_sphere(seed)
    h1, _ = rng.hash1(seed)
    sx = jax.lax.stop_gradient(sx)
    sy = jax.lax.stop_gradient(sy)
    sz = jax.lax.stop_gradient(sz)
    h1 = jax.lax.stop_gradient(h1)

    if scatter_mode == "v1":
        # v1 materials (Shader_RT.fx:217-243); flip/near-zero are
        # discrete events -> detached, fuzz saturation stays continuous
        flip = jax.lax.stop_gradient(_dot3(sx, sy, sz, nx, ny, nz) > 0)
        hxx = jnp.where(flip, sx, -sx)
        hyy = jnp.where(flip, sy, -sy)
        hzz = jnp.where(flip, sz, -sz)
        ldx = nx + hxx
        ldy = ny + hyy
        ldz = nz + hzz
        s_eps = 1e-8
        near0 = jax.lax.stop_gradient(
            (jnp.abs(ldx) < s_eps) & (jnp.abs(ldy) < s_eps)
            & (jnp.abs(ldz) < s_eps))
        ddx = jnp.where(near0, nx, ldx)
        ddy = jnp.where(near0, ny, ldy)
        ddz = jnp.where(near0, nz, ldz)
        u1x, u1y, u1z = _normalize3(dx, dy, dz)
        rx, ry, rz = _reflect(u1x, u1y, u1z, nx, ny, nz)
        fz = jnp.clip(param, 0.0, 1.0)
        mdx = rx + fz * hxx
        mdy = ry + fz * hyy
        mdz = rz + fz * hzz
    else:
        ddx, ddy, ddz = _normalize3(nx + sx, ny + sy, nz + sz)
        rx, ry, rz = _reflect(dx, dy, dz, nx, ny, nz)
        mdx, mdy, mdz = _normalize3(rx + param * sx, ry + param * sy,
                                    rz + param * sz)

    is_glass = mat == 2
    ior = jnp.where(is_glass, jnp.maximum(param, 1e-3), 1.5)
    ux, uy, uz = _normalize3(dx, dy, dz)
    ratio = jnp.where(front, 1.0 / ior, ior)
    cosine = jnp.minimum(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    sine = jnp.sqrt(jnp.maximum(1.0 - cosine * cosine, 0.0))
    cannot = ratio * sine > 1.0
    use_reflect = jax.lax.stop_gradient(
        cannot | (_schlick(cosine, ratio) > h1))
    rfx, rfy, rfz = _reflect(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _refract(ux, uy, uz, nx, ny, nz, ratio)
    gdx = jnp.where(use_reflect, rfx, tx)
    gdy = jnp.where(use_reflect, rfy, ty)
    gdz = jnp.where(use_reflect, rfz, tz)

    is_d = mat == 0
    is_m = mat == 1
    atr = jnp.where(is_glass, 1.0, albedo[..., 0])
    atg = jnp.where(is_glass, 1.0, albedo[..., 1])
    atb = jnp.where(is_glass, 1.0, albedo[..., 2])
    odx = jnp.where(is_d, ddx, jnp.where(is_m, mdx, gdx))
    ody = jnp.where(is_d, ddy, jnp.where(is_m, mdy, gdy))
    odz = jnp.where(is_d, ddz, jnp.where(is_m, mdz, gdz))

    skr, skg, skb = _sky(dx, dy, dz)
    out_r = jnp.where(missed, cr * skr, 0.0)
    out_g = jnp.where(missed, cg * skg, 0.0)
    out_b = jnp.where(missed, cb * skb, 0.0)

    n_cr = jnp.where(scat, cr * atr, cr)
    n_cg = jnp.where(scat, cg * atg, cg)
    n_cb = jnp.where(scat, cb * atb, cb)
    n_ox = jnp.where(scat, px, ox)
    n_oy = jnp.where(scat, py, oy)
    n_oz = jnp.where(scat, pz, oz)
    n_dx = jnp.where(scat, odx, dx)
    n_dy = jnp.where(scat, ody, dy)
    n_dz = jnp.where(scat, odz, dz)

    return ((n_ox, n_oy, n_oz), (n_dx, n_dy, n_dz),
            (n_cr, n_cg, n_cb), (out_r, out_g, out_b))


def _near_miss_sweep(scene: Scene, ro, rd):
    """Closest near-miss sphere per ray: argmax of the (negative)
    discriminant over forward-facing spheres.  O(P*N); only run when
    silhouette gradients are enabled (vis_w > 0)."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    cx, cy, cz = scene.center[:, 0], scene.center[:, 1], scene.center[:, 2]
    rad = scene.radius
    ocx = rox[..., None] - cx
    ocy = roy[..., None] - cy
    ocz = roz[..., None] - cz
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)[..., None]
    half_b = (ocx * rdx[..., None] + ocy * rdy[..., None]
              + ocz * rdz[..., None])
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = half_b * half_b - a * c
    # forward-facing misses only (closest approach ahead of the origin)
    score = jnp.where((half_b < 0) & (disc < 0), disc, -_INF)
    m_idx = jnp.argmax(score, axis=-1).astype(jnp.int32)
    has_nm = jnp.max(score, axis=-1) > -_INF
    return m_idx, has_nm


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def trace_adjoint(scene: Scene, ro, rd, seed, depth: int, t_min: float,
                  vis_w: float = 0.0, scatter_mode: str = "v2"):
    """Drop-in for golden.trace with the hand-structured backward.

    ``vis_w > 0`` additionally gives the backward pass **silhouette
    (boundary) gradients**: forward values are still the exact hard
    render, but d(pixel)/d(center, radius) gains the visibility term via
    a soft-coverage straight-through estimator of width ``~sqrt(vis_w)``
    in world units — the term FD measures across silhouettes and the
    detached-discrete policy otherwise drops.  Use for geometry
    optimization (BASELINE config 3)."""
    out, _ = _trace_fwd_impl(scene, ro, rd, seed, depth, t_min, vis_w,
                             scatter_mode)
    return out


def _trace_fwd_impl(scene, ro, rd, seed, depth, t_min, vis_w=0.0,
                    scatter_mode="v2"):
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    zero = rox * 0.0
    one = zero + 1.0

    def body(st, _):
        (ox, oy, oz, dx, dy, dz, cr, cg, cb, rr, rg, rb, alive, sd) = st
        hit_any, t, idx, normal, front = hit_world(
            scene, (ox, oy, oz), (dx, dy, dz), t_min)

        # event classification (discrete residuals)
        mat = scene.mat_type[idx]
        ok = (mat == 0) | (mat == 1) | (mat == 2)
        scat = alive & hit_any & ok
        absorbed = alive & hit_any & ~ok
        missed = alive & ~hit_any

        res = (ox, oy, oz, dx, dy, dz, cr, cg, cb, idx, scat, missed, sd)
        if vis_w > 0:
            m_idx, has_nm = _near_miss_sweep(
                scene, (ox, oy, oz), (dx, dy, dz))
            res = res + (m_idx, missed & has_nm)

        gathered = _gather_leaves(scene, idx)
        (n_ro, n_rd, n_thr, out) = _bounce_math(
            (ox, oy, oz), (dx, dy, dz), (cr, cg, cb), gathered, mat, sd,
            (scat, missed), t_min, scatter_mode)
        (sx3, sy3, sz3) = n_rd
        _, sd_new = rng.random_in_unit_sphere(sd)

        rr = rr + out[0]
        rg = rg + out[1]
        rb = rb + out[2]
        sd = jnp.where(scat, sd_new, sd)
        alive = alive & ~(missed | absorbed)
        st = (*n_ro, sx3, sy3, sz3, *n_thr, rr, rg, rb, alive, sd)
        return st, res

    st0 = (rox, roy, roz, rdx, rdy, rdz, one, one, one,
           zero, zero, zero, zero < 1.0, seed)
    st, residuals = jax.lax.scan(body, st0, None, length=depth)
    (_, _, _, _, _, _, _, _, _, rr, rg, rb, _, sd) = st
    return ((rr, rg, rb), sd), residuals


def _trace_fwd(scene, ro, rd, seed, depth, t_min, vis_w, scatter_mode):
    out, residuals = _trace_fwd_impl(scene, ro, rd, seed, depth, t_min,
                                     vis_w, scatter_mode)
    ((rr, rg, rb), _) = out
    return out, (scene, residuals, (rr, rg, rb))


def _sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


def _trace_bwd(depth, t_min, vis_w, scatter_mode, saved, ct):
    scene, residuals, (v_r, v_g, v_b) = saved
    (ct_r, ct_g, ct_b), _ = ct  # no cotangent flows through the seed

    zero_scene = Scene(
        center=jnp.zeros_like(scene.center),
        radius=jnp.zeros_like(scene.radius),
        mat_type=None,
        albedo=jnp.zeros_like(scene.albedo),
        mat_param=jnp.zeros_like(scene.mat_param),
    )

    shape = ct_r.shape
    zero = jnp.zeros(shape, jnp.float32)

    # reverse scan over stored bounces: cotangents flow backwards through
    # (ray origin, direction, throughput); radiance contributions add in
    # at the bounce where they were emitted
    def bwd_body(carry, res):
        (d_ox, d_oy, d_oz, d_dx, d_dy, d_dz, d_cr, d_cg, d_cb,
         g_center, g_radius, g_albedo, g_param) = carry
        if vis_w > 0:
            (ox, oy, oz, dx, dy, dz, cr, cg, cb, idx, scat, missed, sd,
             m_idx, nm_valid) = res
        else:
            (ox, oy, oz, dx, dy, dz, cr, cg, cb, idx, scat, missed,
             sd) = res

        mat = scene.mat_type[idx]
        gathered = _gather_leaves(scene, idx)

        def f(ro, rd, thr, gathered):
            return _bounce_math(ro, rd, thr, gathered, mat, sd,
                                (scat, missed), t_min, scatter_mode)

        _, vjp = jax.vjp(f, (ox, oy, oz), (dx, dy, dz), (cr, cg, cb),
                         gathered)
        ct_out = ((d_ox, d_oy, d_oz), (d_dx, d_dy, d_dz),
                  (d_cr, d_cg, d_cb), (ct_r, ct_g, ct_b))
        (n_ro, n_rd, n_thr, g_gathered) = vjp(ct_out)

        gc, gr, ga, gp = g_gathered
        n = scene.count
        g8 = segment_sum(idx, jnp.concatenate([
            gc.reshape(-1, 3), ga.reshape(-1, 3),
            gr.reshape(-1, 1), gp.reshape(-1, 1)], axis=-1), n)
        g_center = g_center + g8[:, 0:3]
        g_albedo = g_albedo + g8[:, 3:6]
        g_radius = g_radius + g8[:, 6]
        g_param = g_param + g8[:, 7]

        if vis_w > 0:
            # -- silhouette (boundary) gradients.  The soft-coverage
            # estimator alpha = sigmoid(disc / (a * vis_w)) is a value
            # -neutral straight-through correction: only d(alpha) enters,
            # scaled by the radiance jump the coverage change would cause.
            skr, skg, skb = _sky(dx, dy, dz)

            def boundary(sel_idx, jump_r, jump_g, jump_b, mask):
                C = scene.center[sel_idx]
                R = scene.radius[sel_idx]
                ocx = ox - C[..., 0]
                ocy = oy - C[..., 1]
                ocz = oz - C[..., 2]
                a = _dot3(dx, dy, dz, dx, dy, dz)
                hb = ocx * dx + ocy * dy + ocz * dz
                c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - R * R
                disc = hb * hb - a * c
                sref = a * jnp.float32(vis_w)
                sig = _sigmoid(disc / sref)
                dsig = sig * (1.0 - sig) / sref
                w_ct = ct_r * jump_r + ct_g * jump_g + ct_b * jump_b
                f = jnp.where(mask, dsig * w_ct, 0.0)
                # d disc / d center = 2a*oc - 2hb*d ; d disc / d radius = 2aR
                gcx = f * (2 * a * ocx - 2 * hb * dx)
                gcy = f * (2 * a * ocy - 2 * hb * dy)
                gcz = f * (2 * a * ocz - 2 * hb * dz)
                grr = f * (2 * a * R)
                dgc = segment_sum(sel_idx, jnp.stack(
                    [gcx.reshape(-1), gcy.reshape(-1), gcz.reshape(-1),
                     grr.reshape(-1)], axis=-1), n)
                return dgc[:, :3], dgc[:, 3]

            # hit side: losing coverage changes this sample from its
            # traced value V to throughput * sky
            dgc, dgr = boundary(idx, v_r - cr * skr, v_g - cg * skg,
                                v_b - cb * skb, scat)
            g_center = g_center + dgc
            g_radius = g_radius + dgr
            # miss side: the nearest forward near-miss sphere gaining
            # coverage.  Covered-radiance estimate BY MATERIAL at the
            # grazing boundary (one bounce then sky):
            #   diffuse -> albedo * sky(boundary normal): the scatter
            #     direction normalize(n + s) averages toward n, and sky
            #     is linear in unit-y, so sky(n) ~ E[sky(dir)];
            #   metal   -> albedo * sky(reflect(d, n)): a grazing
            #     reflection stays near the original direction;
            #   glass   -> sky(reflect(d, n)) with UNIT attenuation
            #     (Schlick reflectance -> 1 at grazing incidence).
            C_m = scene.center[m_idx]
            alb_m = scene.albedo[m_idx]
            mat_m = scene.mat_type[m_idx]
            mocx = ox - C_m[..., 0]
            mocy = oy - C_m[..., 1]
            mocz = oz - C_m[..., 2]
            a_m = _dot3(dx, dy, dz, dx, dy, dz)
            hb_m = mocx * dx + mocy * dy + mocz * dz
            t_ca = -hb_m / a_m  # closest approach along the ray
            nbx, nby, nbz = _normalize3(mocx + t_ca * dx,
                                        mocy + t_ca * dy,
                                        mocz + t_ca * dz)
            udx, udy, udz = _normalize3(dx, dy, dz)
            rfx, rfy, rfz = _reflect(udx, udy, udz, nbx, nby, nbz)
            n_r, n_g, n_b = _sky(nbx, nby, nbz)
            f_r, f_g, f_b = _sky(rfx, rfy, rfz)
            is_dm = mat_m == 0
            is_gm = mat_m == 2

            def est(alb_c, sky_n, sky_f):
                return jnp.where(
                    is_dm, alb_c * sky_n,
                    jnp.where(is_gm, sky_f, alb_c * sky_f))

            dgc, dgr = boundary(
                m_idx,
                cr * est(alb_m[..., 0], n_r, f_r) - v_r,
                cg * est(alb_m[..., 1], n_g, f_g) - v_g,
                cb * est(alb_m[..., 2], n_b, f_b) - v_b,
                nm_valid)
            g_center = g_center + dgc
            g_radius = g_radius + dgr

        carry = (*n_ro, *n_rd, *n_thr, g_center, g_radius, g_albedo,
                 g_param)
        return carry, None

    carry0 = (zero, zero, zero, zero, zero, zero, zero, zero, zero,
              zero_scene.center, zero_scene.radius, zero_scene.albedo,
              zero_scene.mat_param)
    carry, _ = jax.lax.scan(bwd_body, carry0, residuals, reverse=True)
    (d_ox, d_oy, d_oz, d_dx, d_dy, d_dz, _, _, _,
     g_center, g_radius, g_albedo, g_param) = carry

    d_scene = Scene(center=g_center, radius=g_radius, mat_type=None,
                    albedo=g_albedo, mat_param=g_param)
    return (d_scene, (d_ox, d_oy, d_oz), (d_dx, d_dy, d_dz), None)


trace_adjoint.defvjp(_trace_fwd, _trace_bwd)


# -- frame and slab adjoint renderers ----------------------------------------

def render_pixels_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                          px, py, vis_w: float = 0.0):
    """golden.render_pixels with the hand-structured trace adjoint
    (sequential RNG: one seed chained through a pixel's samples)."""
    seed = rng.pixel_seed(px.astype(jnp.uint32), py.astype(jnp.uint32))
    fx = px.astype(jnp.float32)
    fy = py.astype(jnp.float32)
    inv_w = inv_extent(cfg.width)
    inv_h = inv_extent(cfg.height)
    zero = fx * 0.0

    def sample(carry, _):
        acc_r, acc_g, acc_b, sd = carry
        (j1a, _), sd = rng.hash2(sd)
        (_, j2b), sd = rng.hash2(sd)
        u = (fx + j1a * 1.1) * inv_w
        v = (fy + j2b * 1.1) * inv_h
        ro, rd, sd = get_ray(cam, u, v, sd)
        (r, g, b), sd = trace_adjoint(scene, ro, rd, sd, cfg.depth,
                                      cfg.t_min, vis_w, cfg.scatter_mode)
        return (acc_r + r, acc_g + g, acc_b + b, sd), None

    (acc_r, acc_g, acc_b, _), _ = jax.lax.scan(
        sample, (zero, zero, zero, seed), None, length=cfg.spp)
    inv_spp = jnp.float32(1.0 / cfg.spp)
    return _to_gamma(acc_r * inv_spp, cfg.gamma), \
        _to_gamma(acc_g * inv_spp, cfg.gamma), \
        _to_gamma(acc_b * inv_spp, cfg.gamma)


def _pad_to(x, m):
    pad = (-x.shape[0]) % m
    return jnp.concatenate([x, jnp.broadcast_to(x[-1], (pad,))]) if pad \
        else x


def render_flat_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                        px, py, vis_w: float = 0.0):
    """Flat (n,) pixel coordinates -> (n, 3) colors whose backward is the
    hand-structured adjoint.  Chunked over pixels with ``lax.map``.

    In the "parallel" RNG mode spp folds into the ray batch (every
    (pixel, sample) pair is an independent slot, no sequential seed
    chain), removing the spp scan from both sweeps.
    """
    n = px.shape[0]
    if cfg.rng_mode != "parallel":
        chunk = min(cfg.chunk_pixels, n)

        def do_chunk(xy):
            r, g, b = render_pixels_adjoint(scene, cam, cfg, xy[0], xy[1],
                                            vis_w)
            return jnp.stack([r, g, b], axis=-1)

        chunks = jax.lax.map(
            do_chunk, (_pad_to(px, chunk).reshape(-1, chunk),
                       _pad_to(py, chunk).reshape(-1, chunk)))
        return chunks.reshape(-1, 3)[:n]

    spp = cfg.spp
    slots = n * spp
    chunk = min(max(cfg.chunk_pixels, 131072), slots)
    pad = (-slots) % chunk
    slot = jnp.arange(slots + pad, dtype=jnp.int32)
    pix = jnp.minimum(slot // spp, n - 1)
    smp = (slot % spp).astype(jnp.uint32)
    inv_w = inv_extent(cfg.width)
    inv_h = inv_extent(cfg.height)

    def do_chunk(args):
        cpx, cpy, cs = args
        sd = rng.fold_in(
            rng.pixel_seed(cpx.astype(jnp.uint32),
                           cpy.astype(jnp.uint32)), cs)
        fx = cpx.astype(jnp.float32)
        fy = cpy.astype(jnp.float32)
        (j1a, _), sd = rng.hash2(sd)
        (_, j2b), sd = rng.hash2(sd)
        u = (fx + j1a * 1.1) * inv_w
        v = (fy + j2b * 1.1) * inv_h
        ro, rd, sd = get_ray(cam, u, v, sd)
        (r, g, b), _ = trace_adjoint(scene, ro, rd, sd, cfg.depth,
                                     cfg.t_min, vis_w, cfg.scatter_mode)
        return jnp.stack([r, g, b], axis=-1)

    sums = jax.lax.map(
        do_chunk,
        (px[pix].reshape(-1, chunk), py[pix].reshape(-1, chunk),
         smp.reshape(-1, chunk)))
    lin = sums.reshape(-1, 3)[:slots].reshape(n, spp, 3)
    lin = jnp.sum(lin, axis=1) * jnp.float32(1.0 / spp)
    return _to_gamma(lin, cfg.gamma)


def render_rows_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                        row0, rows: int, vis_w: float = 0.0):
    """Rows [row0, row0 + rows) of the cfg frame -> (rows, W, 3), with
    the adjoint backward.  ``row0`` may be traced (sharded train step)."""
    w = cfg.width
    flat = jnp.arange(rows * w, dtype=jnp.int32)
    px = flat % w
    py = row0 + flat // w
    return render_flat_adjoint(scene, cam, cfg, px, py, vis_w).reshape(
        rows, w, 3)


@functools.partial(jax.jit, static_argnums=(2, 3))
def render_golden_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                          vis_w: float = 0.0):
    """Full-frame render whose backward uses the hand-structured adjoint.

    Forward values equal render_golden up to f32 reassociation; gradients
    equal jax.grad-of-golden (same detach policy) at O(P*depth) backward
    cost instead of O(P*depth*N).  ``vis_w > 0`` adds silhouette
    gradients for geometry optimization (see trace_adjoint).
    """
    return render_rows_adjoint(scene, cam, cfg, 0, cfg.height, vis_w)
