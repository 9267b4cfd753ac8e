"""The DeMoN v1 archive reader of the port (``data/demon_v1.py``) against the JAX package's,
on the cases of ``tests/test_data.py``: the fixture writer's bytes, the converter (both
packages convert the port's fixture the same, and the geometry survives), the in-place
``DemonV1Dataset`` sample for sample equal to JAX's at the same seed and to the converted
flat archive, incomplete groups skipped, the raw-array and K/R/t variants, the converter's
command line, and ``on_demon --demon_v1`` training off an archive in place.
"""
import json
import os

import numpy as np
import pytest

from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)
from tf_depth_estimation_torch.data import demon_v1
from tf_depth_estimation_torch.data.demon import DemonDataset, DemonReaderParams
from tf_depth_estimation_torch.data.demon_v1 import (
    DemonV1Dataset,
    convert_demon_v1,
    write_demon_v1_h5,
)
from tf_depth_estimation_torch.data.synthetic import _rotvec_to_matrix_np
from tf_depth_estimation_torch.train.experiments import on_demon

H, W = 32, 48


def _arrays(path: str) -> dict:
    """Every dataset of an HDF5 file, by its path, as numpy."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, node: out.__setitem__(name, np.asarray(node))
                     if isinstance(node, h5py.Dataset) else None)
    return out


def _same_files(a: str, b: str):
    fa, fb = _arrays(a), _arrays(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


@pytest.fixture(scope="module")
def v1_archive(tmp_path_factory):
    """The port's fixture: 3 samples at 32x48, lossless webp, and its flat conversion."""
    root = tmp_path_factory.mktemp("v1")
    src = write_demon_v1_h5(os.path.join(str(root), "v1.h5"), num_scenes=3, H=H, W=W,
                            seed=7)
    dst = os.path.join(str(root), "flat.h5")
    assert convert_demon_v1([src], dst) == 3
    return src, dst


@pytest.mark.parametrize("encode", ["webp", "raw"])
def test_fixture_writer_writes_jaxs_archive(tmp_path, encode):
    """The port's writer and JAX's write the same datasets at the same arguments."""
    from tf_depth_estimation_tpu.data.demon_v1 import write_demon_v1_h5 as jwrite

    ours = write_demon_v1_h5(str(tmp_path / "ours.h5"), num_scenes=2, H=16, W=24, seed=3,
                             encode=encode)
    ref = jwrite(str(tmp_path / "ref.h5"), num_scenes=2, H=16, W=24, seed=3, encode=encode)
    _same_files(ours, ref)


def test_converter_matches_jax_and_keeps_the_geometry(v1_archive, tmp_path):
    """Both packages convert the port's fixture to the same flat archive; the image pair
    (lossless webp) and depth (float16) round-trip, the motion recomposes the two cameras
    (``R_rel R0 = R1``, ``R_rel t0 + t_rel = t1``), the principal point stays normalised,
    and the converted archive feeds ``DemonDataset``."""
    import h5py

    from tf_depth_estimation_tpu.data.demon_v1 import convert_demon_v1 as jconvert

    src, dst = v1_archive
    ref = str(tmp_path / "ref.h5")
    assert jconvert([src], ref) == 3
    _same_files(dst, ref)
    with h5py.File(src, "r") as fs, h5py.File(dst, "r") as fd:
        keys = sorted(fd.keys())
        assert len(keys) == 3
        for i, k in enumerate(keys):
            g, sv = fd[k], fs[f"seq{i:03d}-0/frames/t0"]
            assert g["image_pair"].shape == (H, W, 6) and g["depth"].shape == (H, W)
            np.testing.assert_array_equal(np.asarray(g["depth"]),
                                          np.asarray(sv["v0/depth"]).astype(np.float32))
            cam0, cam1 = np.asarray(sv["v0/camera"]), np.asarray(sv["v1/camera"])
            R0, t0 = cam0[5:14].reshape(3, 3), cam0[14:17]
            R1, t1 = cam1[5:14].reshape(3, 3), cam1[14:17]
            m = np.asarray(g["motion"])
            R_rel = _rotvec_to_matrix_np(m[:3].astype(np.float64))
            np.testing.assert_allclose(R_rel @ R0, R1, atol=1e-5)
            np.testing.assert_allclose(R_rel @ t0 + m[3:], t1, atol=1e-5)
            np.testing.assert_allclose(np.asarray(g["intrinsics"])[2:], [0.5, 0.5], atol=1e-7)
    params = DemonReaderParams(scaled_height=H, scaled_width=W, augment_rot180=0.0,
                               augment_mirror_x=0.0)
    ds = DemonDataset([(dst, 1.0)], params, seed=0)
    s = ds[0]
    assert s["image_pair"].shape == (H, W, 6) and s["depth0"].shape == (H, W, 1)
    assert np.isfinite(s["depth0"]).all()
    np.testing.assert_allclose(np.linalg.norm(s["translation"]), 1.0, rtol=1e-5)
    ds.close()


def test_v1_dataset_matches_jax_and_the_flat_archive(v1_archive):
    """``DemonV1Dataset`` reads the v1 layout in place: items (augmented by their index's
    generator) and scene-pool draws equal to JAX's ``DemonV1Dataset`` at the same seed, and
    each item equal to the converted flat archive's."""
    from tf_depth_estimation_tpu.data.demon import DemonReaderParams as JParams
    from tf_depth_estimation_tpu.data.demon_v1 import DemonV1Dataset as JDemonV1Dataset

    src, dst = v1_archive
    kw = dict(scaled_height=H, scaled_width=W)
    ours = DemonV1Dataset([(src, 1.0)], DemonReaderParams(**kw), seed=0)
    ref = JDemonV1Dataset([(src, 1.0)], JParams(**kw), seed=0)
    flat = DemonDataset([(dst, 1.0)], DemonReaderParams(**kw), seed=0)
    assert len(ours) == len(ref) == len(flat) == 3
    draws = [(ours[i], ref[i]) for i in range(3)] + [(ours[i], flat[i]) for i in range(3)]
    ra, rb = np.random.RandomState(0), np.random.RandomState(0)
    draws += [(ours.sample(ra), ref.sample(rb)) for _ in range(4)]
    for a, b in draws:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for ds in (ours, ref, flat):
        ds.close()


def test_v1_dataset_skips_incomplete_groups(tmp_path):
    """Groups without two views or without v0's depth, and stray datasets, are not
    samples."""
    import h5py

    src = write_demon_v1_h5(str(tmp_path / "v1.h5"), num_scenes=2, H=16, W=32, seed=1)
    with h5py.File(src, "a") as f:
        f.create_group("broken/frames/t0/v0")  # no image, depth or v1
        f.create_dataset("stray", data=np.zeros(3))
        f.create_dataset("odd/frames/t0", data=np.zeros(2))  # frames/t0 a dataset
    ds = DemonV1Dataset([(src, 1.0)], DemonReaderParams(scaled_height=16, scaled_width=32))
    assert len(ds) == 2 and [k for _, k in ds._keys] == ["seq000-0", "seq001-0"]
    ds.close()


def test_converter_reads_raw_images_and_K_R_t_as_jax(tmp_path):
    """The tolerated variants, raw image arrays and per-view K / R / t datasets, convert as
    JAX converts them: the identity rotation and a unit translation on each axis."""
    import h5py

    from tf_depth_estimation_tpu.data.demon_v1 import convert_demon_v1 as jconvert

    src = str(tmp_path / "v1raw.h5")
    rng = np.random.RandomState(0)
    with h5py.File(src, "w") as f:
        g = f.create_group("s0")
        for v in ("v0", "v1"):
            view = g.create_group(f"frames/t0/{v}")
            view.create_dataset("image", data=rng.randint(0, 255, (16, 24, 3), dtype=np.uint8))
            view.create_dataset("K", data=np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]))
            view.create_dataset("R", data=np.eye(3))
            view.create_dataset("t", data=np.zeros(3) if v == "v0" else np.ones(3))
            if v == "v0":
                view.create_dataset("depth", data=np.full((16, 24), 2.0, np.float32))
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    assert convert_demon_v1([src], ours) == jconvert([src], ref) == 1
    _same_files(ours, ref)
    with h5py.File(ours, "r") as fd:
        np.testing.assert_allclose(np.asarray(fd[sorted(fd.keys())[0]]["motion"]),
                                   [0, 0, 0, 1, 1, 1], atol=1e-7)


def test_converter_command_line(v1_archive, tmp_path, capsys):
    """``python -m tf_depth_estimation_torch.data.demon_v1 SRC SRC -o OUT``: the samples of
    both sources, in order, the same as the converter's."""
    src, dst = v1_archive
    out = str(tmp_path / "out.h5")
    assert demon_v1.main([src, src, "-o", out]) == 6
    assert "wrote 6 samples" in capsys.readouterr().out
    got = _arrays(out)
    assert len({k.split("/")[0] for k in got}) == 6
    flat = _arrays(dst)
    for k, v in flat.items():
        assert np.array_equal(got[k], v), k


def test_on_demon_streams_v1_archives(tmp_path):
    """``on_demon --demon_v1`` trains off a classic archive in place (``demon_loader``
    selects ``DemonV1Dataset``), ``--device cpu``, 2 float32 steps, finite records."""
    root = tmp_path / "v1data"
    root.mkdir()
    write_demon_v1_h5(str(root / "scenes11_train.h5"), num_scenes=4, H=32, W=64)
    ckpt = str(tmp_path / "ck")
    state, last = on_demon.main([
        "--dataset_dir", str(root), "--checkpoint_dir", ckpt, "--image_height", "32",
        "--image_width", "64", "--batch_size", "2", "--max_steps", "2", "--summary_freq",
        "1", "--save_latest_freq", "2", "--dtype", "float32", "--device", "cpu",
        "--demon_v1"])
    assert state.step == 2 and np.isfinite(last["total"])
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
