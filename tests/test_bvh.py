"""BVH build invariants + traversal vs brute force (numpy oracle level)."""

import numpy as np
import jax.numpy as jnp

import raytpu
from raytpu import bvh as bvh_mod


def _brute(centers, radii, ro, rd, t_min=1e-3):
    best_t, best_i = np.inf, -1
    for i in range(len(radii)):
        oc = ro - centers[i]
        a = rd @ rd
        half_b = oc @ rd
        c = oc @ oc - radii[i] * radii[i]
        disc = half_b * half_b - a * c
        if disc < 0:
            continue
        sq = np.sqrt(disc)
        root = (-half_b - sq) / a
        if root < t_min:
            root = (-half_b + sq) / a
        if root >= t_min and root < best_t:
            best_t, best_i = root, i
    return best_t, best_i


def test_build_invariants():
    scene = raytpu.random_world(seed=1, half_extent=5)
    b = bvh_mod.build_bvh(scene, leaf_size=4, pad_leaves=False)
    nodes = np.asarray(b.nodes)
    perm = np.asarray(b.perm).astype(int)
    n, m = scene.count, len(nodes)

    # perm is a permutation
    assert sorted(perm.tolist()) == list(range(n))
    # every sphere appears in exactly one leaf; leaves tile [0, n)
    leaves = nodes[nodes[:, 7] > 0]
    spans = sorted((int(r[6]), int(r[7])) for r in leaves)
    cursor = 0
    for start, count in spans:
        assert start == cursor
        cursor += count
    assert cursor == n
    # skip pointers are strictly forward and land in [node+1, m]
    for i, r in enumerate(nodes):
        assert i + 1 <= int(r[8]) <= m
    # children boxes nested in parents (preorder: child = i+1 for interior)
    centers = np.asarray(scene.center)[perm]
    radii = np.asarray(scene.radius)[perm]
    for i, r in enumerate(nodes):
        if r[7] > 0:
            for j in range(int(r[6]), int(r[6]) + int(r[7])):
                assert (centers[j] - radii[j] >= r[0:3] - 1e-3).all()
                assert (centers[j] + radii[j] <= r[3:6] + 1e-3).all()


def test_traversal_matches_brute_force():
    scene = raytpu.random_world(seed=2, half_extent=6)
    b = bvh_mod.build_bvh(scene, leaf_size=4, pad_leaves=False)
    perm = np.asarray(b.perm).astype(int)
    centers = np.asarray(scene.center, np.float64)[perm]
    radii = np.asarray(scene.radius, np.float64)[perm]

    rs = np.random.default_rng(0)
    origins = rs.uniform(-15, 15, (64, 3))
    origins[:, 1] = rs.uniform(0.1, 8, 64)
    dirs = rs.normal(size=(64, 3))

    for ro, rd in zip(origins, dirs):
        t_b, i_b = bvh_mod.closest_hit_numpy(b.nodes, centers, radii, ro, rd)
        t_r, i_r = _brute(centers, radii, ro, rd)
        if np.isinf(t_r):
            assert np.isinf(t_b)
        else:
            np.testing.assert_allclose(t_b, t_r, rtol=1e-12)
            assert i_b == i_r


def test_single_sphere_and_leaf_sizes():
    scene = raytpu.config1_world()
    for leaf in (1, 2, 8):
        b = bvh_mod.build_bvh(scene, leaf_size=leaf, pad_leaves=False)
        perm = np.asarray(b.perm).astype(int)
        centers = np.asarray(scene.center, np.float64)[perm]
        radii = np.asarray(scene.radius, np.float64)[perm]
        t, i = bvh_mod.closest_hit_numpy(
            b.nodes, centers, radii,
            np.array([0.0, 0.2, 1.0]), np.array([0.0, -0.05, -1.0]))
        assert np.isfinite(t)


def test_permute_scene_roundtrip():
    scene = raytpu.random_world(seed=4, half_extent=3)
    b = bvh_mod.build_bvh(scene, pad_leaves=False)
    ps = bvh_mod.permute_scene(scene, b.perm)
    perm = np.asarray(b.perm).astype(int)
    np.testing.assert_array_equal(
        np.asarray(ps.center), np.asarray(scene.center)[perm])
    np.testing.assert_array_equal(
        np.asarray(ps.mat_type), np.asarray(scene.mat_type)[perm])


def test_padded_leaf_invariants():
    """pad_leaves (the default): every leaf holds exactly leaf_size
    entries, real spheres appear once, dummies are -1 -> NaN rows that
    can never win a hit."""
    scene = raytpu.random_world(seed=1, half_extent=5)
    b = bvh_mod.build_bvh(scene, leaf_size=4)
    assert b.leaf_size == 4
    assert b.n_nodes == 8 * b.n_trav  # 8 octant-ordered copies
    nodes = np.asarray(b.nodes)[:b.n_trav]  # copy 0 (+x +y +z)
    perm = np.asarray(b.perm).astype(int)
    n = scene.count
    reals = sorted(p for p in perm.tolist() if p >= 0)
    assert reals == list(range(n))
    leaves = nodes[nodes[:, 7] > 0]
    assert (leaves[:, 7] == 4).all()
    spans = sorted((int(r[6]), int(r[7])) for r in leaves)
    cursor = 0
    for start, count in spans:
        assert start == cursor
        cursor += count
    # leaf entries tile [0, len - n_outliers); split-out outliers
    # (random_world's ground sphere) ride the tail
    assert cursor == len(perm) - b.n_outliers
    assert b.n_outliers == 1
    # permuted scene: dummy rows are NaN and never intersect
    ps = bvh_mod.permute_scene(scene, b.perm)
    centers = np.asarray(ps.center, np.float64)
    radii = np.asarray(ps.radius, np.float64)
    assert np.isnan(centers[perm < 0]).all()
    rs = np.random.default_rng(3)
    for _ in range(32):
        ro = rs.uniform(-12, 12, 3)
        ro[1] = rs.uniform(0.1, 6)
        rd = rs.normal(size=3)
        t, i = bvh_mod.closest_hit_numpy(nodes, centers, radii, ro, rd,
                                         n_outliers=b.n_outliers)
        if i >= 0:
            assert perm[i] >= 0  # a dummy never wins


def test_octant_orders_consistent():
    """Each of the 8 octant-ordered node copies is a valid preorder of
    the SAME tree: identical (t, winning sphere) for every ray."""
    scene = raytpu.random_world(seed=6, half_extent=5)
    b = bvh_mod.build_bvh(scene, leaf_size=4)
    m = b.n_trav
    nodes = np.asarray(b.nodes)
    perm = np.asarray(b.perm).astype(int)
    ps = bvh_mod.permute_scene(scene, b.perm)
    centers = np.asarray(ps.center, np.float64)
    radii = np.asarray(ps.radius, np.float64)
    rs = np.random.default_rng(7)
    for _ in range(48):
        ro = rs.uniform(-12, 12, 3)
        ro[1] = rs.uniform(0.1, 6)
        rd = rs.normal(size=3)
        t0, i0 = bvh_mod.closest_hit_numpy(nodes[:m], centers, radii,
                                           ro, rd)
        for o in range(1, 8):
            t, i = bvh_mod.closest_hit_numpy(
                nodes[o * m:(o + 1) * m], centers, radii, ro, rd)
            if np.isinf(t0):
                assert np.isinf(t)
            else:
                np.testing.assert_allclose(t, t0, rtol=1e-12)
                assert perm[i] == perm[i0]


def test_native_builder_matches_numpy():
    """C++ builder output is bit-identical to the numpy reference."""
    import pytest
    from raytpu import native
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    for seed, leaf in ((1, 1), (2, 4), (3, 8), (4, 16)):
        scene = raytpu.random_world(seed=seed, half_extent=5)
        a = bvh_mod.build_bvh(scene, leaf_size=leaf, use_native=True)
        b = bvh_mod.build_bvh(scene, leaf_size=leaf, use_native=False)
        np.testing.assert_array_equal(np.asarray(a.nodes),
                                      np.asarray(b.nodes))
        np.testing.assert_array_equal(np.asarray(a.perm),
                                      np.asarray(b.perm))


def test_sah_builder_invariants_and_traversal():
    """Native binned-SAH builder: same layout contract as median split
    (perm permutation, leaf tiling, forward skip pointers, containment)
    and traversal agrees with brute force."""
    import pytest
    from raytpu import native
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    scene = raytpu.final_world()
    b = bvh_mod.build_bvh(scene, leaf_size=8, builder="sah",
                          pad_leaves=False)
    nodes = np.asarray(b.nodes)
    perm = np.asarray(b.perm).astype(int)
    n, m = scene.count, len(nodes)
    assert sorted(perm.tolist()) == list(range(n))
    leaves = nodes[nodes[:, 7] > 0]
    assert (leaves[:, 7] <= 8).all()
    spans = sorted((int(r[6]), int(r[7])) for r in leaves)
    cursor = 0
    for start, count in spans:
        assert start == cursor
        cursor += count
    assert cursor == n
    for i, r in enumerate(nodes):
        assert i + 1 <= int(r[8]) <= m
    centers = np.asarray(scene.center, np.float64)[perm]
    radii = np.asarray(scene.radius, np.float64)[perm]
    rs = np.random.default_rng(11)
    for _ in range(48):
        ro = rs.uniform(-12, 12, 3)
        ro[1] = rs.uniform(0.1, 6)
        rd = rs.normal(size=3)
        t_b, i_b = bvh_mod.closest_hit_numpy(nodes, centers, radii, ro, rd)
        t_r, i_r = _brute(centers, radii, ro, rd)
        if np.isinf(t_r):
            assert np.isinf(t_b)
        else:
            np.testing.assert_allclose(t_b, t_r, rtol=1e-12)
            assert i_b == i_r


def test_outlier_split_invariants():
    """split_outliers (default): the giant ground sphere leaves the
    tree, rides the perm tail, and the numpy oracle (which tests the
    tail unconditionally) still agrees with brute force over ALL
    spheres."""
    scene = raytpu.final_world()
    b = bvh_mod.build_bvh(scene, leaf_size=8)
    n = scene.count
    perm = np.asarray(b.perm)
    assert b.n_outliers == 1
    # tail entry is the ground sphere (the unique radius outlier)
    radii_all = np.abs(np.asarray(scene.radius, np.float64))
    assert radii_all[int(perm[-1])] == radii_all.max()
    # non-dummy perm entries are a permutation of [0, n)
    real = perm[perm >= 0].astype(int)
    assert sorted(real.tolist()) == list(range(n))
    # tree leaves never contain the outlier
    leaf_entries = perm[:-b.n_outliers]
    assert int(perm[-1]) not in leaf_entries[leaf_entries >= 0].astype(int)

    from raytpu.bvh import permute_scene
    ps = permute_scene(scene, b.perm)
    centers = np.asarray(ps.center, np.float64)
    radii = np.asarray(ps.radius, np.float64)
    nodes = np.asarray(b.nodes, np.float64)[: b.n_trav]  # octant copy 0
    c_orig = np.asarray(scene.center, np.float64)
    r_orig = np.asarray(scene.radius, np.float64)
    rs = np.random.default_rng(7)
    for _ in range(48):
        ro = rs.uniform(-12, 12, 3)
        ro[1] = rs.uniform(0.1, 6)
        rd = rs.normal(size=3)
        t_b, i_b = bvh_mod.closest_hit_numpy(
            nodes, centers, radii, ro, rd, n_outliers=b.n_outliers)
        t_r, i_r = _brute(c_orig, r_orig, ro, rd)
        if np.isinf(t_r):
            assert np.isinf(t_b)
        else:
            np.testing.assert_allclose(t_b, t_r, rtol=1e-12)
            assert int(perm[i_b]) == i_r


def test_outlier_split_caps_large_populations():
    """A bimodal-radius scene (many 'outliers') must NOT split: each
    split sphere becomes a statically-unrolled unconditional test per
    bounce, which past a handful defeats the tree."""
    rs = np.random.default_rng(0)
    rows = []
    for i in range(48):
        big = i % 2 == 0
        rows.append((tuple(rs.uniform(-20, 20, 3)),
                     100.0 if big else 1.0, 0, (0.5, 0.5, 0.5), 0.0))
    scene = raytpu.make_scene(rows)
    b = bvh_mod.build_bvh(scene, leaf_size=8)
    assert b.n_outliers == 0
    # ... but a handful still splits
    scene2 = raytpu.final_world()
    assert bvh_mod.build_bvh(scene2, leaf_size=8).n_outliers == 1


def test_refit_restores_correctness_after_moves():
    """An optimizer that moves a sphere outside its build-time leaf box
    silently loses it (the stale-BVH bug refit exists for); refit'd
    boxes restore exact agreement with the brute-force closest hit."""
    from raytpu.camera import get_ray
    # two clusters in separate leaves (leaf 4): A in view at the
    # origin, B BEHIND the camera (never entered by any camera ray)
    spheres = [((dx, 0.3, dz), 0.4, 0, (0.6, 0.3, 0.3), 0.0)
               for dx in (-0.8, 0.8) for dz in (-0.8, 0.8)]
    spheres += [((30.0 + dx, 2.0, 3.0 + dz), 0.4, 0, (0.2, 0.6, 0.2),
                 0.0) for dx in (-0.8, 0.8) for dz in (-0.8, 0.8)]
    scene0 = raytpu.make_scene(spheres)
    b = bvh_mod.build_bvh(scene0, leaf_size=4)
    cam = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                             vfov=20.0, aspect=2.0)
    # move a cluster-B sphere (leaf never entered -> stale boxes lose
    # it) squarely into the view
    moved = scene0._replace(
        center=scene0.center.at[5].set(jnp.asarray([0.0, 0.5, 0.0])),
        radius=scene0.radius.at[5].set(0.6))
    pm = bvh_mod.permute_scene(moved, b.perm)
    centers = np.asarray(pm.center, np.float64)
    radii = np.asarray(pm.radius, np.float64)
    u, v = np.meshgrid(np.linspace(0.3, 0.7, 12), np.linspace(0.3, 0.7, 6))
    ro, rd, _ = get_ray(cam, jnp.asarray(u.ravel(), jnp.float32),
                        jnp.asarray(v.ravel(), jnp.float32),
                        jnp.zeros(u.size, jnp.uint32))
    ro = np.stack([np.asarray(x, np.float64) for x in ro], -1)
    rd = np.stack([np.asarray(x, np.float64) for x in rd], -1)

    def walk(bvh):
        nodes = np.asarray(bvh.nodes)[:bvh.n_trav]
        return [bvh_mod.closest_hit_numpy(nodes, centers, radii, o, d,
                                          n_outliers=bvh.n_outliers)[1]
                for o, d in zip(ro, rd)]

    want = [_brute(centers, radii, o, d)[1] for o, d in zip(ro, rd)]
    assert walk(b) != want, \
        "move did not exercise the stale-box path; pick another sphere"
    assert walk(bvh_mod.refit(b, moved)) == want


def test_refit_identity_matches_build_boxes():
    """refit at the build-time geometry reproduces the builder's leaf
    boxes (same mins/maxes + pad) in flat AND the nodes' leaf rows."""
    scene = raytpu.random_world(seed=1, half_extent=3)
    b = bvh_mod.build_bvh(scene)
    r = bvh_mod.refit(b, scene)
    np.testing.assert_allclose(np.asarray(r.flat[:, 0:6]),
                               np.asarray(b.flat[:, 0:6]),
                               rtol=0, atol=1e-5)
    is_leaf = np.asarray(b.nodes[:, 7]) > 0
    np.testing.assert_allclose(
        np.asarray(r.nodes[is_leaf, 0:6]),
        np.asarray(b.nodes[is_leaf, 0:6]), rtol=0, atol=1e-5)
    # interior rows are voided to always-enter
    assert (np.asarray(r.nodes[~is_leaf, 0]) == -3.0e38).all()
