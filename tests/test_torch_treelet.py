"""The port's treelet layer (parallel/treelet.py) against the JAX
package's: the Morton order and the blocks' records, the sequential ring
against JAX intersect_ring (the file's first JAX call) and the port's single
tree, and, in a spawned world of 4 gloo ranks (rows 2 x scene 2,
tests/torch_dist_worker.py), the send/recv ring, intersect_sharded, the
treelet renderer and a ShardedTree train step against the sequential
ring on the host, on a frame whose height the ranks divide and on one
(6x8) whose height they do not: there also edge-aware frames against
JAX shade_edgeaware on the same shards (the file's second JAX call),
path frames and a path-mode train step on explicit draws."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from clpathtracer_tpu.parallel import treelet as jtreelet
from clpathtracer_tpu_torch.accel.sah import build_kd_tree
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.diff.grad import intersect_diff
from clpathtracer_tpu_torch.ops.traverse_fast import traverse_fast
from clpathtracer_tpu_torch.parallel.mesh import render_block
from clpathtracer_tpu_torch.parallel.train import make_train_step
from clpathtracer_tpu_torch.parallel.treelet import (
    ShardedTree, build_sharded_tree, intersect_ring, morton_order, shard_of)
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      path_draws,
                                                      render_image)
from clpathtracer_tpu_torch.scene.procedural import random_tri_soup
from torch_dist_worker import WORLD, run_world, soup, soup_rays

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scene():
    s = soup()
    return s, s.tri_corners()


@pytest.fixture(scope="module")
def sequential(scene):
    """The soup's 2-block tree and the sequential ring on the 32x32 rays."""
    sc, tv = scene
    stree = build_sharded_tree(tv, 2, device=CPU)
    cam, o, d = soup_rays()
    return stree, o, d, intersect_ring(stree, o, d)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("treelet_world"), "treelet")


def test_morton_order_matches_jax():
    pts = np.random.default_rng(0).random((1000, 3)).astype(np.float32)
    order = morton_order(pts)
    assert sorted(order) == list(range(1000))
    np.testing.assert_array_equal(order, jtreelet.morton_order(pts))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_blocks_match_jax(scene, n_shards):
    """Node tables, global slots and records (geometry and global ids,
    pads included) equal to the JAX build's."""
    _, tv = scene
    st = build_sharded_tree(tv, n_shards, device=CPU)
    js = jtreelet.build_sharded_tree(tv, n_shards)
    assert st.total_blocks == js.total_blocks == n_shards
    np.testing.assert_array_equal(st.node_table.numpy(),
                                  np.asarray(js.node_table))
    np.testing.assert_array_equal(st.tri_slots.numpy(),
                                  np.asarray(js.tri_slots))
    np.testing.assert_array_equal(
        st.tris.numpy(), np.asarray(js.quads).reshape(st.tris.shape))
    np.testing.assert_array_equal(
        st.leaf_start.numpy(), st.node_table[..., 10].numpy() * 4)
    # every triangle lives in exactly one block
    sets = [np.unique(b[b >= 0]) for b in st.tri_slots.numpy()]
    assert sum(x.size for x in sets) == np.unique(np.concatenate(
        sets)).size == tv.shape[0]


def test_sequential_ring_matches_jax(scene, sequential):
    _, tv = scene
    stree, o, d, rec = sequential
    js = jtreelet.build_sharded_tree(tv, 2)
    ref = jax.jit(lambda a, b: jtreelet.intersect_ring(js, a, b))(
        o.numpy(), d.numpy())
    hit = np.asarray(ref["hit"])
    np.testing.assert_array_equal(rec["hit"].numpy(), hit)
    np.testing.assert_array_equal(rec["tri"].numpy()[hit],
                                  np.asarray(ref["tri"])[hit])
    np.testing.assert_allclose(rec["t"].numpy()[hit],
                               np.asarray(ref["t"])[hit], rtol=1e-5,
                               atol=1e-6)
    assert 0 < hit.sum() < hit.size


def test_sequential_ring_matches_single_tree(scene, sequential):
    _, tv = scene
    stree, o, d, rec = sequential
    single = build_kd_tree(tv, max_depth=22, leaf_size=4, device=CPU)
    ref = traverse_fast(single, o, d)
    hit = ref["hit"]
    assert torch.equal(rec["hit"], hit)
    torch.testing.assert_close(rec["t"][hit], ref["t"][hit], rtol=1e-5,
                               atol=1e-6)
    # S = 4 walks the same hits
    rec4 = intersect_ring(build_sharded_tree(tv, 4, device=CPU), o, d)
    assert torch.equal(rec4["hit"], hit)
    assert torch.equal(rec4["t"], rec["t"])


def test_gloo_ring_bit_matches_sequential(sequential, world):
    """The send/recv ring over each "scene" pair, every rank its own
    quarter of the rays: hit and t bit-equal to the sequential ring."""
    _, _, _, rec = sequential
    hit = np.concatenate([w["ring_hit"] for w in world])
    t = np.concatenate([w["ring_t"] for w in world])
    np.testing.assert_array_equal(hit, rec["hit"].numpy())
    np.testing.assert_array_equal(t[hit], rec["t"].numpy()[hit])
    # no cross-block exact-t tie on the soup: the winners agree too
    tri = np.concatenate([w["ring_tri"] for w in world])
    np.testing.assert_array_equal(tri, rec["tri"].numpy())


def test_intersect_sharded_matches_sequential(sequential, world):
    """Each rank walks its resident block; the MIN / MIN / SUM reductions
    over "scene" give the sequential ring's hit, t and tri, the same on
    both ranks of a pair."""
    _, _, _, rec = sequential
    for r in range(WORLD):
        w, mate = world[r], world[r ^ 1]
        rows = slice((r // 2) * 512, (r // 2 + 1) * 512)
        hit = rec["hit"].numpy()[rows]
        np.testing.assert_array_equal(w["sh_hit"], hit)
        np.testing.assert_array_equal(w["sh_t"][hit],
                                      rec["t"].numpy()[rows][hit])
        np.testing.assert_array_equal(w["sh_tri"], rec["tri"].numpy()[rows])
        np.testing.assert_array_equal(w["sh_t"], mate["sh_t"])


def test_treelet_renderer_matches_render_image(scene, sequential, world):
    sc, _ = scene
    stree = sequential[0]
    cam, _, _ = soup_rays()
    ref = render_image(sc, cam, RenderOptions(32, 32), tree=stree).numpy()
    for w in world:
        np.testing.assert_array_equal(w["image"], ref)


def test_treelet_flat_blocks_match_single_tree(scene, world):
    """A 6x8 frame on 4 ranks (H % 4 != 0, N % 4 == 0): each rank's ring
    on its range of 12 pixels, gathered, equals the sequential ring and
    the single tree's walk in hit, t and tri; the treelet frame equals
    render_image through the ring and through the single tree, bit for
    bit."""
    sc, tv = scene
    cam, o, d = soup_rays(8, 6)
    stree = build_sharded_tree(tv, 2, device=CPU)
    seq = intersect_ring(stree, o, d)
    single = build_kd_tree(tv, max_depth=22, leaf_size=4, device=CPU)
    ref = traverse_fast(single, o, d)
    hit = np.concatenate([w["ring6_hit"] for w in world])
    assert 0 < hit.sum() < hit.size
    for rec in (seq, ref):
        np.testing.assert_array_equal(hit, rec["hit"].numpy())
        np.testing.assert_array_equal(
            np.concatenate([w["ring6_t"] for w in world])[hit],
            rec["t"].numpy()[hit])
        np.testing.assert_array_equal(
            np.concatenate([w["ring6_tri"] for w in world]),
            torch.where(rec["hit"], rec["tri"], -1).numpy())
    opts = RenderOptions(8, 6)
    for tree in (stree, single):
        img = render_image(sc, cam, opts, tree=tree).numpy()
        for w in world:
            np.testing.assert_array_equal(w["image6"], img)


def test_sharded_tree_train_step_flat_blocks(world):
    """A ShardedTree train step on the 6x8 frame over 4 ranks of 12
    pixels: the loss equals the one-device step's (through the
    sequential ring) within 1e-6 relative, the ranks' partial means
    being summed in another order, and is the same on every rank."""
    small = soup(1000)
    s_stree = build_sharded_tree(small.tri_corners(), 2, device=CPU)
    cam, _, _ = soup_rays(8, 6)
    step, init = make_train_step(
        small, RenderOptions(8, 6, differentiable=True),
        lambda p: torch.optim.Adam(p.values(), lr=1e-3), tree=s_stree)
    _, loss = step(init({"verts": small.verts}), cam,
                   torch.full((6, 8, 3), 0.5))
    for w in world:
        assert w["loss6"] == world[0]["loss6"]
        np.testing.assert_allclose(w["loss6"], float(loss), rtol=1e-6,
                                   atol=0.0)


@pytest.fixture(scope="module")
def jax_edge_blocks(scene):
    """JAX shade_edgeaware on each of the 4 ranges of 12 rays of the 6x8
    frame, through its sequential ring: the JAX package's treelet frame
    shades such a shard as one row of 12 pixels (its cols = n). One jit,
    four calls."""
    from clpathtracer_tpu.render import integrator as jint
    from clpathtracer_tpu.scene.procedural import random_tri_soup as jsoup
    _, tv = scene
    js = jsoup(4000, seed=2, extent=2.0, tri_size=0.05)
    np.testing.assert_array_equal(np.asarray(js.tri_corners()), tv)
    jtree = jtreelet.build_sharded_tree(tv, 2)
    jopts = jint.RenderOptions(width=8, height=6, edge_aware=True)
    shade = jax.jit(lambda a, b: jint.shade_edgeaware(js, jtree, a, b, jopts,
                                                      None))
    _, o, d = soup_rays(8, 6)
    return np.concatenate([np.asarray(shade(o[k * 12:(k + 1) * 12].numpy(),
                                            d[k * 12:(k + 1) * 12].numpy()))
                           for k in range(WORLD)])


def test_treelet_flat_edge_aware_matches_jax(scene, world, jax_edge_blocks):
    """The edge-aware 6x8 treelet frame on 4 ranks: each range of 12
    pixels is shaded with the band over one row of 12, as JAX
    shade_edgeaware shades such a shard, within 1e-4 of it (the band's
    quotient m / |grad m| carries the float differences of the two
    packages' u, v), bit for bit the host's render_block through the
    sequential ring, and the band moves pixels off the plain frame."""
    sc, tv = scene
    cam, _, _ = soup_rays(8, 6)
    stree = build_sharded_tree(tv, 2, device=CPU)
    opts = RenderOptions(8, 6, edge_aware=True)
    host = torch.cat([render_block(sc, cam, opts, k, WORLD, tree=stree)
                      for k in range(WORLD)]).numpy()
    for w in world:
        img = w["image6e"].reshape(-1, 3)
        np.testing.assert_array_equal(img, host)
        np.testing.assert_allclose(img, jax_edge_blocks, rtol=0.0,
                                   atol=1e-4)
        assert (np.abs(img - w["image6"].reshape(-1, 3)).max(axis=-1)
                > 1e-3).sum() >= 4


def test_treelet_flat_path_matches_blocks(scene, world):
    """The 6x8 path frame (spp 2, NEE with a light stride of 4) on 4
    ranks of an emitting soup: every rank's range drawn from its
    block_generator, bit for bit the host's render_block of that range
    through the sequential ring, and the same frame on every rank."""
    _, tv = scene
    lit = soup(emissive_frac=0.3)
    np.testing.assert_array_equal(lit.tri_corners(), tv)
    cam, _, _ = soup_rays(8, 6)
    stree = build_sharded_tree(tv, 2, device=CPU)
    opts = RenderOptions(8, 6, mode="path", spp=2, bounces=2, nee=True,
                         nee_light_stride=4)
    host = torch.cat([render_block(
        lit, cam, opts, k, WORLD, tree=stree,
        generator=torch.Generator().manual_seed(5)) for k in range(WORLD)])
    assert len(torch.unique(host)) > 8
    for w in world:
        np.testing.assert_array_equal(w["image6p"].reshape(-1, 3),
                                      host.numpy())


def test_sharded_tree_train_step_flat_path_draws(world):
    """A path-mode ShardedTree train step (spp 2, NEE, light stride 4) on
    the 6x8 frame over 4 ranks, on the full frame's explicit draws: each
    rank takes its 12 pixels' jitter, bounce and light uniforms, and the
    loss equals the one-device step's on the same draws within 1e-6
    relative. A light stride of 8, whose runs the ranges split, raises."""
    lit_small = soup(1000, emissive_frac=0.3)
    s_stree = build_sharded_tree(lit_small.tri_corners(), 2, device=CPU)
    cam, _, _ = soup_rays(8, 6)
    opts = RenderOptions(8, 6, mode="path", spp=2, bounces=2, nee=True,
                         nee_light_stride=4, differentiable=True)
    draws = path_draws(opts, torch.Generator().manual_seed(7), CPU)
    step, init = make_train_step(
        lit_small, opts, lambda p: torch.optim.Adam(p.values(), lr=1e-3),
        tree=s_stree)
    _, loss = step(init({"verts": lit_small.verts}), cam,
                   torch.full((6, 8, 3), 0.5), draws)
    for w in world:
        assert w["loss6p"] == world[0]["loss6p"]
        np.testing.assert_allclose(w["loss6p"], float(loss), rtol=1e-6,
                                   atol=0.0)
        assert "not whole runs of nee_light_stride 8" in str(w["stride8"])


def test_sharded_tree_train_step(world):
    """One Adam step on the verts with the treelet ring on the 4 ranks:
    finite loss, the vertices moved, and equal on every rank."""
    small = soup(1000)
    for w in world:
        assert np.isfinite(w["loss"]) and w["loss"] == world[0]["loss"]
        np.testing.assert_array_equal(w["verts"], world[0]["verts"])
    assert np.abs(world[0]["verts"] - small.verts.numpy()).max() > 0.0


def test_ring_routes_and_refusals(scene, sequential):
    """A ShardedTree carries intersect_diff's topology (the
    differentiable t equal to the plain ring's, a gradient to the
    vertices) and NEE's shadow rays (a path frame of an emissive soup
    through the ring within the tie budget of the single tree's); the
    packet route, bf16, a grid or a shadow tree beside it raise; shard_of
    keeps one block."""
    sc, tv = scene
    stree, o, d, rec = sequential
    verts = sc.verts.clone().requires_grad_(True)
    dr = intersect_diff(sc.with_verts(verts), stree, o, d,
                        RenderOptions(32, 32, differentiable=True),
                        coherent=True)
    assert torch.equal(dr["hit"], rec["hit"])
    assert torch.equal(dr["tri"], rec["tri"])
    torch.testing.assert_close(dr["t"].detach(), rec["t"], rtol=1e-6,
                               atol=0.0)
    dr["t"][dr["hit"]].sum().backward()
    assert bool(verts.grad.abs().sum() > 0)
    lamp = random_tri_soup(1500, seed=6, extent=1.0, tri_size=0.12,
                           emissive_frac=0.02, device=CPU)
    p_opts = RenderOptions(16, 16, mode="path", bounces=2, nee=True,
                           background=0.0)
    lcam = Camera.create([0.0, 0.0, -3.0], [0.0, 0.0, 1.0], device=CPU)
    imgs = [render_image(lamp, lcam, p_opts, tree=t,
                         generator=torch.Generator().manual_seed(0)).numpy()
            for t in (build_sharded_tree(lamp.tri_corners(), 4, device=CPU),
                      build_kd_tree(lamp.tri_corners(), max_depth=22,
                                    leaf_size=4, device=CPU))]
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.0
    assert (np.abs(imgs[0] - imgs[1]).max(axis=-1) > 1e-5).mean() < 1.5e-2
    cam, _, _ = soup_rays()
    for bad in (dict(intersector="packet"), dict(precision="bf16")):
        with pytest.raises(ValueError, match="ShardedTree"):
            render_image(sc, cam, RenderOptions(32, 32, **bad), tree=stree)
    with pytest.raises(ValueError, match="ShardedTree"):
        render_image(sc, cam, RenderOptions(32, 32), tree=stree,
                     shadow=build_kd_tree(tv, device=CPU))
    one = shard_of(stree, 1)
    assert one.num_shards == 1 and one.total_blocks == 2
    assert torch.equal(one.tris[0], stree.tris[1])
    assert isinstance(dataclasses.replace(one, group=None), ShardedTree)
