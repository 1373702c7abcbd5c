"""W1's split-leaf rule on hand-built edge waves
(walk_cases.walk_edge_cases, which chip_smoke.py runs on the card against
the plain version on every lane): the port's plain walk
(ray_walk_reference, and traverse_fast on the CPU) against the winners and steps that follow from where the triangles sit,
and against the JAX package's traverse_fast (XLA on the CPU, no Pallas) on
every case without a step cap (its cap is global, the port's per lane).
Then W2's tie wave (walk_cases.bf_tie_case): the plain brute force and the
JAX package's nearest_hit_bruteforce give the last of equal-t copies."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import sah as jsah
from clpathtracer_tpu.ops import intersect as jisx
from clpathtracer_tpu.ops import traverse_fast as jtf
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch import walk_cases as wc
from clpathtracer_tpu_torch.ops import intersect as tisx
from clpathtracer_tpu_torch.ops import traverse_fast as ttf

torch.set_num_threads(2)
CPU = torch.device("cpu")
CASES = wc.walk_edge_cases()


def _trees(tv, build):
    jt = jsah.build_kd_tree(tv, tri_block=4, backend="python", **build)
    tt = interop.kd_tree_from_numpy(
        *(np.asarray(getattr(jt, f)) for f in (
            "node_min", "node_max", "is_leaf", "split_axis", "split_value",
            "child_lo", "child_hi", "leaf_start", "leaf_count", "ropes",
            "tri_indices")), tv, 4, device=CPU)
    return jt, tt


def _torch_wave(wave):
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in wave.items()}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_edge_wave(case):
    name, tv, build, wave, (slot, steps, t) = case
    jt, tt = _trees(tv, build)
    ids = tt.tris[:, 9].to(torch.int64)
    if name.startswith("one leaf"):
        # one leaf; records in build order (triangle j in row j), padded
        assert tt.num_nodes == 1 and int(tt.leaf_count[0]) == wc.EDGE_LEAF
        assert torch.equal(ids[:wc.EDGE_LEAF], torch.arange(wc.EDGE_LEAF))
    else:
        # a split on x at the root; the straddler (16) ends both leaves
        assert tt.num_nodes == 3 and not bool(tt.is_leaf[0])
        assert int(tt.node_table[0, 7]) == 0
        assert tt.leaf_start.tolist()[1:] == [0, 12]
        assert ids[8] == 16 and ids[20] == 16
    tw = _torch_wave(wave)
    best_t, best_slot, st = ttf.ray_walk_reference(tt, **tw)
    np.testing.assert_array_equal(best_slot.numpy(), slot)
    np.testing.assert_array_equal(st.numpy(), steps)
    np.testing.assert_array_equal(best_t.numpy(), t)
    # the wrapper on the CPU: the record of the same walk
    rec = ttf.traverse_fast(tt, **tw)
    hit = slot >= 0
    np.testing.assert_array_equal(rec["hit"].numpy(), hit)
    np.testing.assert_array_equal(rec["steps"].numpy(), steps)
    want_tri = np.where(hit, ids[np.maximum(slot, 0)].numpy(), -1)
    if wave.get("any_hit"):
        want_tri = np.where(hit, 0, -1)
    np.testing.assert_array_equal(rec["tri"].numpy(), want_tri)
    if "max_iters" in wave:
        return       # the JAX loop caps all lanes together
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in wave.items() if k not in ("orig", "dir")}
    ref = jtf.traverse_fast(jt, jt.quads, jnp.asarray(wave["orig"]),
                            jnp.asarray(wave["dir"]), compact=False, **kw)
    np.testing.assert_array_equal(np.asarray(ref["hit"]), hit)
    np.testing.assert_array_equal(np.asarray(ref["steps"]), steps)
    np.testing.assert_array_equal(np.asarray(ref["tri"]), want_tri)
    np.testing.assert_allclose(np.asarray(ref["t"])[hit], t[hit], rtol=1e-6)


def test_brute_force_ties():
    """Equal-t copies of each aimed-at record: in its own tile, a later
    tile and past the end (another chunk of the plain scan; another split
    of W2's): the last copy wins."""
    js = jproc.terrain_mesh(2_000, seed=2, extent=10.0)
    faces = np.asarray(js.faces)
    scene = interop.scene_from_numpy(js.verts, faces, js.normals, js.albedo,
                                     js.emission, device=CPU)
    f = scene.num_tris
    targets = np.arange(0, f - 400, 97)[:12]
    copies = [np.array([t, t + 1, t + 300, f + k])
              for k, t in enumerate(targets)]
    rows, o, d, want = wc.bf_tie_case(scene.tri_records, targets, copies)
    assert o.shape[0] == 12
    recs = scene.tri_records[rows].contiguous()
    hit, _, prim, _, _ = tisx.brute_force_reference(recs, o, d, chunk=256)
    assert hit.all()
    np.testing.assert_array_equal(prim.numpy(), want.numpy())
    # the JAX oracle over the same triangles (the copies as faces)
    jscene = type(js).create(js.verts, faces[rows.numpy()])
    ref = jisx.nearest_hit_bruteforce(jscene, jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(np.asarray(ref["prim_id"]), want.numpy())
