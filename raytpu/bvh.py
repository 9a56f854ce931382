"""Bounding-volume hierarchy — NEW capability (SURVEY.md §2 #10: the
reference has no acceleration structure; its hit_world is a brute-force
loop over all spheres, CSVersion/ShaderCompute.hlsl:188-205).

Design (SURVEY.md §7 hard-part 4):

- **Host-side median-split build** over sphere centroids (numpy; a native
  C++ builder can swap in behind the same layout for very large scenes).
- **Flattened preorder + skip pointers** ("threaded" BVH): one array of
  nodes in DFS preorder; a hit on an interior node falls through to
  ``node + 1``; a miss jumps to ``skip``.  Traversal is a single while
  loop with NO stack.

No renderer consumes the BVH today: the GPU engine's closest hit is a
brute-force sweep.  The layout, the refit and the numpy reference
traversal are kept for a GPU traversal kernel, in which each thread can
walk its own ray.

Layout: ``nodes`` is (M, 9) f32 — rows
``[min_x, min_y, min_z, max_x, max_y, max_z, start, count, skip]``;
``count == 0`` marks an interior node; ``start/count`` index the PERMUTED
sphere order (``perm``); integers are stored as f32 (exact below 2^24) so
the whole structure is a float PyTree and rides ``jax.custom_vjp`` with
zero cotangents.

**Octant-ordered traversal** (padded static-leaf BVHs, the default):
``nodes`` holds EIGHT preorder copies of the tree, shape (8*M, 9) —
copy ``o`` orders every internal node's children FRONT-TO-BACK for rays
whose direction-sign octant is ``o`` (bit 2 = x < 0, bit 1 = y < 0,
bit 0 = z < 0, matching the kernels' octant key).  A tile picks the
copy matching its majority live-lane octant, so the nearest leaves are
visited first, ``t_best`` tightens immediately, and far subtrees die on
the ``tfar <= t_best`` clamp.  Hit results are IDENTICAL in any order
(closest-hit with predicated winner updates is order-independent);
only the amount of culling changes.  ``start``/``count``/``perm`` are
shared by all copies.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from raytpu.scene import Scene


def outlier_tail(perm, flat, leaf_size):
    """(base, count) of the split-out outlier tail (see
    build_bvh(split_outliers=...)), or None.  Derived from STATIC
    shapes only — perm rows beyond the padded leaf entries are the
    outliers — so it is computable on traced operands inside jit.
    THE single source of truth for the tail layout (kernels and
    BVH.n_outliers both call it)."""
    if flat is None or not leaf_size:
        return None
    base = (flat.shape[0] // 8) * leaf_size
    cnt = int(perm.shape[0]) - base
    return (base, cnt) if cnt else None


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["nodes", "perm", "flat"],
                   meta_fields=["leaf_size"])
@dataclasses.dataclass(frozen=True)
class BVH:
    nodes: jnp.ndarray  # (M, 9) f32: bbox lo(3) hi(3), start, count, skip
    perm: jnp.ndarray   # (P,) f32: permuted-order -> original sphere
    #                     index, or -1 for leaf-padding dummies
    # static leaf size when every leaf is padded to exactly this many
    # entries (kernels then STATICALLY UNROLL the leaf loop — measured
    # ~1.5x on the sphere-test sweep); None = legacy variable leaves
    leaf_size: int | None = None
    # (8*L, 9) leaf-only rows of the octant-ordered copies (see
    # build_bvh), or None.  Copy ``o``'s leaves appear in that copy's
    # preorder position, i.e. front-to-back for direction octant ``o``.
    # Kernels with few leaves iterate this flat list directly — same
    # leaves entered, same ``tfar <= t_best`` front-to-back culling, but
    # no interior-node visits and no skip-pointer scalar dependency
    # chain between iterations.
    flat: jnp.ndarray | None = None

    @property
    def n_outliers(self) -> int:
        """Outlier spheres split OUT of the tree (``build_bvh``'s
        ``split_outliers``): they occupy the TAIL of ``perm`` after the
        padded leaf entries, and kernels test them unconditionally
        before the walk.  Derived from static shapes (perm length minus
        leaves x leaf_size) so it needs no extra custom_vjp plumbing."""
        tail = outlier_tail(self.perm, self.flat, self.leaf_size)
        return 0 if tail is None else tail[1]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_trav(self) -> int:
        """Nodes per traversal walk — ``nodes`` holds 8 octant-ordered
        copies when ``leaf_size`` is set (padded static leaves)."""
        m = self.nodes.shape[0]
        return m // 8 if self.leaf_size else m

    @property
    def n_leaves(self) -> int:
        """Leaves per octant copy (0 without a flat leaf list)."""
        return 0 if self.flat is None else self.flat.shape[0] // 8


def _pad_leaf_nodes(nodes: np.ndarray, perm: np.ndarray,
                    leaf_size: int):
    """Pad every leaf to EXACTLY ``leaf_size`` entries (dummies = -1 in
    perm; their scene rows become NaN and can never win a hit).  Leaf
    starts/counts are rewritten; node order and bboxes are unchanged."""
    nodes = np.array(nodes, np.float32)
    perm = np.asarray(perm)
    new_perm: list[float] = []
    for r in nodes:
        count = int(r[7])
        if count == 0:
            continue
        start = int(r[6])
        r[6] = float(len(new_perm))
        r[7] = float(leaf_size)
        new_perm.extend(perm[start:start + count].tolist())
        new_perm.extend([-1.0] * (leaf_size - count))
    return nodes, np.asarray(new_perm, np.float32)


def _octant_orders(nodes: np.ndarray) -> np.ndarray:
    """(M, 9) preorder nodes -> (8*M, 9): eight preorder copies, copy
    ``o`` visiting each internal node's children front-to-back for
    direction octant ``o`` (bit 2/1/0 set = dx/dy/dz < 0).

    Children are recovered from the skip-pointer layout (left = i + 1,
    right = skip(left)); the ordering axis is the child-centroid axis of
    greatest separation (the split axis, reconstructed); a negative ray
    direction along that axis visits the larger-centroid child first.
    ``start``/``count`` rows are copied verbatim — all copies index the
    same permuted sphere order."""
    nodes = np.asarray(nodes, np.float32)
    m = len(nodes)
    cent = (nodes[:, 0:3] + nodes[:, 3:6]) * 0.5
    out = np.empty((8, m, 9), np.float32)
    for o in range(8):
        neg = (bool(o & 4), bool(o & 2), bool(o & 1))
        rows = np.empty((m, 9), np.float32)
        pos = 0
        # stack of (orig_index, my_out_slot_or_-1): first visit emits the
        # row, second (slot >= 0) patches its skip pointer
        stack = [(0, -1)]
        while stack:
            i, slot = stack.pop()
            if slot >= 0:
                rows[slot, 8] = float(pos)
                continue
            my = pos
            rows[my] = nodes[i]
            pos += 1
            if nodes[i, 7] == 0:  # interior: order children
                left = i + 1
                right = int(nodes[left, 8])
                axis = int(np.argmax(np.abs(cent[left] - cent[right])))
                first, second = left, right
                if (cent[left][axis] > cent[right][axis]) != neg[axis]:
                    first, second = right, left
                stack.append((i, my))        # patch skip after subtree
                stack.append((second, -1))
                stack.append((first, -1))
            else:
                rows[my, 8] = float(pos)
        assert pos == m
        out[o] = rows
    return out.reshape(8 * m, 9)


def _flat_leaves(nodes_arr: np.ndarray) -> np.ndarray:
    """(8*M, 9) octant-ordered nodes -> (8*L, 9) leaf-only rows (each
    copy's leaves kept in its preorder = front-to-back position)."""
    m = nodes_arr.shape[0] // 8
    copies = nodes_arr.reshape(8, m, 9)
    return np.stack([c[c[:, 7] > 0] for c in copies]).reshape(-1, 9)


_MAX_OUTLIERS = 4


def build_bvh(scene: Scene, leaf_size: int = 64, pad: float = 1e-4,
              use_native: bool = True, pad_leaves: bool = True,
              builder: str = "median",
              split_outliers: bool = True) -> BVH:
    """BVH over the scene's spheres (host-side build).

    ``builder="median"`` (default) splits at the centroid median of the
    longest axis; ``builder="sah"`` uses the native binned surface-area
    -heuristic builder (16 bins/axis; requires the native library,
    falling back to median otherwise).

    **Median is the default**: an earlier accelerator's tile-coherent
    traversal measured SAH slower in every cell it tried, because SAH's
    better-balanced tree makes more leaves for the same cap while its
    headline win (isolating the giant ground sphere) is already taken
    by ``split_outliers``.  A per-ray GPU traversal has to measure it
    again.

    Uses the native C++ builder (native/rt_native.cpp via ctypes) when
    available — same algorithm, bit-identical output, ~100x faster for
    large scenes; falls back to this numpy implementation otherwise
    (``RAYTPU_NO_NATIVE=1`` forces the fallback).

    ``pad`` slightly enlarges every box so slab tests with rays lying
    exactly on a face (NaN from 0 * inf) can only produce false *hits*,
    never false misses — traversal stays conservative.

    ``pad_leaves`` (default) pads every leaf to exactly ``leaf_size``
    entries with can't-hit dummies so kernels statically unroll the
    leaf loop; median splits leave real leaf sizes in
    (leaf_size/2, leaf_size], so the dummy overhead is small.
    Padded BVHs additionally store 8 octant-ordered node copies
    (``nodes`` becomes (8*M, 9), see :func:`_octant_orders`) for
    front-to-back traversal.

    ``split_outliers`` (default, padded BVHs only) keeps outlier-huge
    spheres (radius > 10x the median) OUT of the tree: they ride the TAIL of ``perm`` and
    kernels test them unconditionally before the walk.  A giant ground
    sphere would otherwise (a) blow up its leaf's bbox so every ray
    enters those ``leaf_size`` sphere tests, and (b) under SAH land in
    a near-singleton leaf that padding fills with ``leaf_size - 1``
    dummy tests.  Splitting costs one always-run sphere test per
    outlier and, since such spheres are hit by most rays anyway,
    tightens ``t_best`` BEFORE the walk so far leaves die on the
    ``tfar <= t_best`` clamp.  Images are unchanged (closest-hit is
    test-order independent).
    """
    if builder not in ("median", "sah"):
        raise ValueError(f"unknown builder {builder!r}")
    center = np.asarray(scene.center, np.float64)
    radius = np.asarray(scene.radius, np.float64)
    n_total = len(radius)
    keep = None
    outliers = np.empty(0, np.int64)
    if split_outliers and pad_leaves and n_total >= 2:
        r_abs = np.abs(radius)
        out_mask = r_abs > 10.0 * max(float(np.median(r_abs)), 1e-6)
        # every outlier becomes a statically-unrolled unconditional
        # sphere test per bounce in every kernel: past a handful that
        # defeats the tree (and bloats Mosaic compile time), so a large
        # "outlier" population stays in the tree instead
        if int(out_mask.sum()) > _MAX_OUTLIERS:
            out_mask[:] = False
        if out_mask.any():
            keep = np.nonzero(~out_mask)[0]
            outliers = np.nonzero(out_mask)[0]
            center = center[keep]
            radius = radius[keep]

    def _finish(nodes_arr, perm_arr):
        if pad_leaves:
            nodes_arr, perm_arr = _pad_leaf_nodes(nodes_arr, perm_arr,
                                                  leaf_size)
            nodes_arr = _octant_orders(nodes_arr)
        perm_arr = np.asarray(perm_arr, np.float32)
        if keep is not None:
            # tree perm is subset-relative: remap to original sphere
            # ids (dummies stay -1), then append the outliers' ids
            valid = perm_arr >= 0
            remapped = keep[np.maximum(perm_arr.astype(np.int64), 0)]
            perm_arr = np.where(valid, remapped.astype(np.float32), -1.0)
            perm_arr = np.concatenate(
                [perm_arr, outliers.astype(np.float32)])
        return BVH(nodes=jnp.asarray(nodes_arr),
                   perm=jnp.asarray(perm_arr),
                   leaf_size=leaf_size if pad_leaves else None,
                   flat=(jnp.asarray(_flat_leaves(nodes_arr))
                         if pad_leaves else None))

    if use_native or builder == "sah":
        from raytpu import native
        out = native.build_bvh_native(center, radius, leaf_size, pad,
                                      sah=builder == "sah")
        if out is not None:
            return _finish(*out)
    radius = np.abs(radius)
    lo = center - radius[:, None]
    hi = center + radius[:, None]

    nodes: list[list[float]] = []
    order: list[int] = []

    def rec(idx: np.ndarray) -> None:
        my = len(nodes)
        nodes.append([0.0] * 9)
        b_lo = lo[idx].min(axis=0) - pad
        b_hi = hi[idx].max(axis=0) + pad
        if len(idx) <= leaf_size:
            start = len(order)
            order.extend(int(i) for i in idx)
            nodes[my][:8] = [*b_lo, *b_hi, float(start), float(len(idx))]
        else:
            cent = center[idx]
            axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
            sub = np.argsort(cent[:, axis], kind="stable")
            # split at the centroid median ROUNDED UP to a leaf_size
            # multiple (round 5): leaves then pack full — ceil(n/leaf)
            # leaves instead of pure halving's next-power-of-two count
            # (10k spheres at leaf 64: 157 vs 256 leaves, 0.5% vs 39%
            # NaN dummies — the old inflation overflowed the kernels'
            # 1 MB SMEM scene-pack window at ~10k spheres)
            half = len(idx) // 2
            half = min(-(-half // leaf_size) * leaf_size, len(idx) - 1)
            nodes[my][:8] = [*b_lo, *b_hi, 0.0, 0.0]
            rec(idx[sub[:half]])
            rec(idx[sub[half:]])
        nodes[my][8] = float(len(nodes))  # skip = index after subtree

    rec(np.arange(len(radius)))
    nodes_arr = np.asarray(nodes, np.float32)
    assert len(order) == len(radius)
    perm_arr = np.asarray(order, np.float32)
    return _finish(nodes_arr, perm_arr)


def refit(bvh: BVH, scene: Scene, pad: float = 1e-4) -> BVH:
    """Recompute the BVH's bounding boxes for the CURRENT geometry,
    keeping the tree topology / perm / leaf order — jit-safe, so
    optimization steps that MOVE spheres can refresh the boxes
    in-graph instead of a host rebuild.

    Without this, a train step that keeps the build-time BVH silently
    loses any sphere that drifts outside its leaf box (traversal culls
    the leaf and the sphere disappears from renders AND gradients).
    Refit keeps traversal CORRECT for arbitrary geometry; only the
    culling efficiency degrades as spheres stray from the build-time
    layout (the standard refit-vs-rebuild trade).

    Leaf boxes are recomputed exactly (NaN leaf-padding dummies are
    skipped; the ``pad`` matches build_bvh's conservative slab
    padding).  The flat leaf list (the production traversal) gets the
    fresh boxes in every octant copy; the skip-pointer ``nodes``
    array's leaf rows are refreshed too while its INTERIOR boxes are
    voided to always-enter (correct but unculled) — prefer the flat
    path after a refit.  Requires padded static leaves + a flat list.
    """
    assert bvh.leaf_size and bvh.flat is not None, \
        "refit needs padded static leaves with a flat leaf list"
    ls = int(bvh.leaf_size)
    nl = bvh.n_leaves
    pc = permute_scene(scene, bvh.perm)
    c = pc.center[:nl * ls].reshape(nl, ls, 3)
    r = pc.radius[:nl * ls].reshape(nl, ls, 1)
    pad = jnp.float32(pad)
    lo = jnp.nanmin(c - r, axis=1) - pad
    hi = jnp.nanmax(c + r, axis=1) + pad
    leaf_boxes = jnp.concatenate([lo, hi], axis=-1)        # (L, 6)

    flat = jnp.asarray(bvh.flat, jnp.float32)
    fid = (flat[:, 6] / ls).astype(jnp.int32)              # start -> leaf
    new_flat = flat.at[:, 0:6].set(leaf_boxes[fid])

    nodes = jnp.asarray(bvh.nodes, jnp.float32)
    is_leaf = nodes[:, 7] > 0
    nid = jnp.clip((nodes[:, 6] / ls).astype(jnp.int32), 0, nl - 1)
    void = jnp.concatenate([jnp.full((3,), -3.0e38, jnp.float32),
                            jnp.full((3,), 3.0e38, jnp.float32)])
    nboxes = jnp.where(is_leaf[:, None], leaf_boxes[nid], void)
    new_nodes = nodes.at[:, 0:6].set(nboxes)
    return dataclasses.replace(bvh, nodes=new_nodes, flat=new_flat)


def permute_scene(scene: Scene, perm) -> Scene:
    """Reorder scene arrays into BVH leaf order (leaves are contiguous).

    Entries with ``perm == -1`` are leaf-padding dummies: their rows
    become NaN (center/radius/albedo/param), so the quadratic test's
    ``disc >= 0`` is False on every backend and they can never win."""
    p = jnp.asarray(perm).astype(jnp.int32)
    valid = p >= 0
    pc = jnp.maximum(p, 0)
    nan = jnp.float32(jnp.nan)
    return Scene(
        center=jnp.where(valid[:, None], scene.center[pc], nan),
        radius=jnp.where(valid, scene.radius[pc], nan),
        mat_type=jnp.where(valid, scene.mat_type[pc], 0),
        albedo=jnp.where(valid[:, None], scene.albedo[pc], nan),
        mat_param=jnp.where(valid, scene.mat_param[pc], nan),
    )


# ---------------------------------------------------------------------------
# numpy reference traversal (unit-test oracle for the flattened layout)

def closest_hit_numpy(bvh_nodes: np.ndarray, centers: np.ndarray,
                      radii: np.ndarray, ro: np.ndarray, rd: np.ndarray,
                      t_min: float = 1e-3, n_outliers: int = 0):
    """Scalar skip-pointer traversal -> (t, permuted_index) or (inf, -1).

    centers/radii are in PERMUTED order; mirrors the kernel's walk exactly
    (same node order, same slab + quadratic math) in float64.
    ``n_outliers`` tail entries (split_outliers) are tested
    unconditionally before the walk, like the kernels do.
    """
    nodes = np.asarray(bvh_nodes, np.float64)
    m = len(nodes)
    inv = np.where(rd != 0, 1.0 / np.where(rd == 0, 1.0, rd), np.inf)
    best_t, best_i = np.inf, -1
    for i in range(len(centers) - n_outliers, len(centers)):
        oc = ro - centers[i]
        a = rd @ rd
        half_b = oc @ rd
        c = oc @ oc - radii[i] * radii[i]
        disc = half_b * half_b - a * c
        if disc >= 0:
            sq = np.sqrt(disc)
            root = (-half_b - sq) / a
            if root < t_min:
                root = (-half_b + sq) / a
            if root >= t_min and root < best_t:
                best_t, best_i = root, i
    node = 0
    while node < m:
        b = nodes[node]
        t1 = (b[0:3] - ro) * inv
        t2 = (b[3:6] - ro) * inv
        tnear = max(np.minimum(t1, t2).max(), t_min)
        tfar = min(np.maximum(t1, t2).min(), best_t)
        # NaN (origin on a padded face) counts as a hit, exactly like the
        # kernels' conservative ~(tnear > tfar)
        hit_box = not (tnear > tfar)
        start, count, skip = int(b[6]), int(b[7]), int(b[8])
        if hit_box and count > 0:
            for i in range(start, start + count):
                oc = ro - centers[i]
                a = rd @ rd
                half_b = oc @ rd
                c = oc @ oc - radii[i] * radii[i]
                disc = half_b * half_b - a * c
                if not disc >= 0:  # NaN (padding dummy) -> skip
                    continue
                sq = np.sqrt(disc)
                root = (-half_b - sq) / a
                if root < t_min:
                    root = (-half_b + sq) / a
                if root >= t_min and root < best_t:
                    best_t, best_i = root, i
        node = node + 1 if (hit_box and count == 0) else skip
    return best_t, best_i
