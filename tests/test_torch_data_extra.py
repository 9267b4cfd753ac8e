"""The remaining host data code of the port against the JAX package: the single-image
colon dataset (both label branches), the batcher of a restartable sample stream, both
manifest writers and their CLI, the "rich" scene family and the single-image dataset
writer, and the two-view COLMAP writer the refinement path reads.
"""
import filecmp
import os

import numpy as np
import pytest

from torch_fixtures import drop_tmp_path  # noqa: F401 (fixture)
from tf_depth_estimation_torch.colmap import SceneManager
from tf_depth_estimation_torch.data import manifest, synthetic
from tf_depth_estimation_torch.data.colon import SimpleDepthDataset
from tf_depth_estimation_torch.data.pipeline import IterBatcher


def _same_tree(a: str, b: str, names) -> None:
    """Each file ``names`` under ``a`` byte-identical to its twin under ``b``."""
    assert names
    for name in names:
        same = filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False)
        assert same, name


def _files(root: str):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, ns in os.walk(root) for n in ns)


# ---- the writers -------------------------------------------------------------------------

def test_write_simple_depth_dataset_equals_jax(tmp_path):
    """Same JPEGs, labels and manifest (the manifest names each package's own paths)."""
    from tf_depth_estimation_tpu.data import synthetic as jsynthetic

    a = synthetic.write_simple_depth_dataset(str(tmp_path / "port"), num_frames=3, H=40,
                                             W=56, seed=4)
    b = jsynthetic.write_simple_depth_dataset(str(tmp_path / "jax"), num_frames=3, H=40,
                                              W=56, seed=4)
    assert _files(a) == _files(b)
    _same_tree(a, b, [f for f in _files(a) if f != "train.txt"])
    with open(os.path.join(a, "train.txt")) as f, open(os.path.join(b, "train.txt")) as g:
        assert f.read().replace(a, b) == g.read()


@pytest.mark.parametrize("seed", [0, 5])
def test_rich_scene_family_equals_jax(seed):
    """``make_pair_scene(family="rich")`` bit-equal to JAX's from one RandomState, the v1
    family unchanged beside it, and an unknown family refused in both."""
    from tf_depth_estimation_tpu.data import synthetic as jsynthetic

    for family in ("rich", "v1"):
        got = synthetic.make_pair_scene(np.random.RandomState(seed), 24, 40, family=family)
        ref = jsynthetic.make_pair_scene(np.random.RandomState(seed), 24, 40, family=family)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="unknown scene family"):
        synthetic.make_pair_scene(np.random.RandomState(0), 8, 8, family="v2")


def test_rich_colon_pair_dataset_equals_jax(tmp_path):
    from tf_depth_estimation_tpu.data import synthetic as jsynthetic

    a = synthetic.write_colon_pair_dataset(str(tmp_path / "port"), num_frames=3, H=24, W=40,
                                           seed=2, family="rich")
    b = jsynthetic.write_colon_pair_dataset(str(tmp_path / "jax"), num_frames=3, H=24,
                                            W=40, seed=2, family="rich")
    assert _files(a) == _files(b)
    _same_tree(a, b, _files(a))


def test_write_colmap_pair_reads_back(tmp_path):
    """The two-view model's camera, relative pose and anchors as ``SceneManager`` and the
    refine CLI derive them: image 1 at the origin, the anchors' depths in its camera."""
    scene = synthetic.write_colmap_pair(str(tmp_path), H=32, W=48, num_points=7, seed=3)
    sm = SceneManager(scene["model_dir"]).load()
    im1, im2 = (sm.images[sm.name_to_image_id[n]] for n in ("a.jpg", "b.jpg"))
    np.testing.assert_allclose(sm.cameras[im1.camera_id].K, scene["K"], rtol=1e-7)
    np.testing.assert_allclose(im2.pose @ np.linalg.inv(im1.pose), scene["relative_pose"],
                               atol=1e-6)
    pts, obs = sm.get_points3D(im1.image_id)
    np.testing.assert_allclose(obs, scene["sparse_xy"], rtol=1e-6)
    np.testing.assert_allclose(((im1.R @ pts.T).T + im1.tvec)[:, 2], scene["sparse_z"],
                               rtol=1e-6)
    pts2, obs2 = sm.get_points3D(im2.image_id)
    proj = sm.cameras[im2.camera_id].project((im2.R @ pts2.T).T + im2.tvec)
    np.testing.assert_allclose(proj, obs2, atol=1e-4)
    assert sorted(os.listdir(scene["image_dir"])) == ["a.jpg", "b.jpg"]


# ---- SimpleDepthDataset ------------------------------------------------------------------

@pytest.mark.parametrize("stored", [(32, 32), (40, 40)], ids=["training_size", "square"])
def test_simple_depth_dataset_equals_jax(tmp_path, stored):
    """Images and inverse-depth labels of both packages' loaders: labels stored at the
    training size, and square labels of another size (side^2 values, area-resized). The
    port's resize sums in another order (``data/colon.py:_resize_np``), so a resized
    sample agrees to float32 rounding."""
    from tf_depth_estimation_tpu.data.colon import SimpleDepthDataset as JSimple

    root = synthetic.write_simple_depth_dataset(str(tmp_path), num_frames=2, H=stored[0],
                                                W=stored[1], seed=1)
    got = SimpleDepthDataset(root, resized_height=32, resized_width=32)
    ref = JSimple(root, resized_height=32, resized_width=32)
    assert len(got) == len(ref) == 2 and got.label_paths == ref.label_paths
    for i in range(2):
        g, r = got[i], ref[i]
        assert sorted(g) == sorted(r) == ["image", "label"]
        for k in g:
            assert g[k].shape == r[k].shape == (32, 32, 3 if k == "image" else 1)
            assert g[k].dtype == np.float32
            if stored == (32, 32):
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=1e-7, err_msg=k)


# ---- IterBatcher -------------------------------------------------------------------------

def _source(n: int, log: list):
    """A restartable source of ``n`` samples; each run appends to ``log``."""
    def factory():
        log.append("epoch")
        for i in range(n):
            yield {"x": np.full((2,), i, np.float32), "i": np.int64(i)}
    return factory


def test_iter_batcher_carries_partial_batches_like_jax():
    """5 samples a pass in batches of 3 over 3 passes: 5 batches, the partial batch of
    each pass completed by the next one's first samples, the last 0 dropped; the same as
    JAX's, batch by batch."""
    from tf_depth_estimation_tpu.data.pipeline import IterBatcher as JIterBatcher

    log, jlog = [], []
    got = list(IterBatcher(_source(5, log), 3, num_epochs=3))
    ref = list(JIterBatcher(_source(5, jlog), 3, num_epochs=3))
    assert len(got) == len(ref) == 5 and log == jlog == ["epoch"] * 3
    assert [b["i"].tolist() for b in got] == [[0, 1, 2], [3, 4, 0], [1, 2, 3], [4, 0, 1],
                                              [2, 3, 4]]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in g:
            np.testing.assert_array_equal(g[k], r[k])


def test_iter_batcher_refuses_an_empty_source():
    with pytest.raises(ValueError, match="no samples"):
        next(iter(IterBatcher(_source(0, []), 2)))


# ---- the manifests -----------------------------------------------------------------------

def test_simple_manifest_equals_jax(tmp_path):
    """Only the frames with a label; the same lines as JAX's writer."""
    from tf_depth_estimation_tpu.data import manifest as jmanifest

    root = synthetic.write_simple_depth_dataset(str(tmp_path), num_frames=3, H=16, W=16)
    os.remove(os.path.join(root, "frame0001.jpg_z.bin"))
    got = open(manifest.make_simple_manifest(root, split="a")).read()
    ref = open(jmanifest.make_simple_manifest(root, split="b")).read()
    assert got == ref and got.count("\n") == 2 and "frame0001" not in got


@pytest.mark.parametrize("cli", [False, True], ids=["function", "main"])
def test_pair_manifest_equals_jax(tmp_path, cli, capsys):
    """``sub id1 id2`` lines of the packed pairs with their depth and camera files, by the
    function and through ``main``, the same as JAX's."""
    from tf_depth_estimation_tpu.data import manifest as jmanifest

    root = synthetic.write_colon_pair_dataset(str(tmp_path), num_frames=3, H=16, W=24)
    os.remove(os.path.join(root, "seq0", "0001_0002_cam.txt"))
    if cli:
        got = manifest.main(["--dataset_dir", root, "--split", "a"])
        assert "(2 entries)" in capsys.readouterr().out
    else:
        got = manifest.make_pair_manifest(root, split="a")
    ref = jmanifest.make_pair_manifest(root, split="b")
    assert open(got).read() == open(ref).read() == "seq0 0000 0001\nseq0 0002 0003\n"
