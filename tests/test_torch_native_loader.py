"""The C++ loader in the port (``data/native.py`` over ``native/fastloader.cc``, built with
g++ into ``build/native/``) against the JAX package's binding and the port's NumPy
dataset, its threads, a corrupt JPEG, ``depth_only --native_loader`` and the refusal
where it cannot build."""
import json
import os
import shutil

import numpy as np
import pytest

from tf_depth_estimation_torch.data import native
from tf_depth_estimation_torch.data.colon import PairDepthDataset
from tf_depth_estimation_torch.data.synthetic import write_colon_pair_dataset
from tf_depth_estimation_torch.train.experiments import depth_only
from torch_fixtures import drop_tmp_path  # noqa: F401 (autouse)

H, W = 48, 144


def _tol_check(got: dict, ref: dict):
    """The limits of tests/test_native_loader.py:28-32: libjpeg's DCT rounding can differ
    from cv2's by ~1 level; the resize math is the same."""
    np.testing.assert_allclose(got["tgt_image"], ref["tgt_image"], atol=2.5)
    np.testing.assert_allclose(got["src_image"], ref["src_image"], atol=2.5)
    np.testing.assert_allclose(got["label"], ref["label"], atol=1e-5)
    np.testing.assert_allclose(got["intrinsics"], ref["intrinsics"], rtol=1e-6)
    np.testing.assert_allclose(got["tgt2src_projs"], ref["tgt2src_projs"], rtol=1e-6)


@pytest.fixture(scope="module")
def colon_root(tmp_path_factory):
    return write_colon_pair_dataset(str(tmp_path_factory.mktemp("colon_native")),
                                    num_frames=5, H=H, W=W)


def _dataset(root):
    return PairDepthDataset(root, split="train", image_height=H, image_width=W,
                            resized_height=H, resized_width=W)


def test_builds_from_the_source_into_build_not_the_committed_library():
    assert native.available(), native.build_error()
    built = native.build()
    assert os.path.dirname(built["path"]) == native.BUILD_DIR
    assert os.path.basename(built["path"]).startswith("fastloader-")
    assert "-march=native" not in native.CXXFLAGS


def test_native_matches_jax_and_the_numpy_dataset(colon_root):
    """One thread, in order: every sample of the split, within the decode limits of the
    NumPy dataset, and equal to what the JAX package's binding gives where its committed
    library loads."""
    from tf_depth_estimation_tpu.data import PairDepthDataset as JPairDepthDataset
    from tf_depth_estimation_tpu.data import native as jnative

    ds = _dataset(colon_root)
    got = list(native.NativePairSampler(ds, num_threads=1, shuffle=False))
    assert len(got) == len(ds) == 3
    for i, sample in enumerate(got):
        _tol_check(sample, ds[i])
        assert sample["m_scale"].dtype == np.float32
    if jnative.available():
        jds = JPairDepthDataset(colon_root, split="train", image_height=H, image_width=W,
                                resized_height=H, resized_width=W)
        want = list(jnative.NativePairSampler(jds, num_threads=1, shuffle=False))
        assert len(want) == len(got)
        for g, r in zip(got, want):
            assert sorted(g) == sorted(r)
            for k in g:
                np.testing.assert_allclose(g[k], r[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_shuffled_order_is_the_seeds(colon_root):
    """One thread, shuffled: the samples come in ``RandomState(seed)``'s order."""
    ds = _dataset(colon_root)
    order = np.arange(len(ds))
    np.random.RandomState(4).shuffle(order)
    got = [s["m_scale"] for s in native.NativePairSampler(ds, num_threads=1, seed=4)]
    want = [ds[i]["m_scale"] for i in order]
    np.testing.assert_array_equal(got, want)


def test_multithreaded_run_is_complete(colon_root):
    ds = _dataset(colon_root)
    seen = sorted(float(s["m_scale"]) for s in native.NativePairSampler(ds, num_threads=4))
    assert seen == sorted(float(ds[i]["m_scale"]) for i in range(len(ds)))


def test_a_corrupt_jpeg_is_skipped(colon_root, tmp_path):
    """A corrupt frame is skipped (as the reference's queue runners move on), not a call
    to exit() through libjpeg's fatal handler."""
    root = tmp_path / "corrupt"
    shutil.copytree(colon_root, root)
    ds = _dataset(str(root))
    with open(ds.entries[0]["image"], "wb") as f:
        f.write(b"\xff\xd8\xff\xe0NOT A JPEG" + b"\x00" * 64)
    got = list(native.NativePairSampler(ds, num_threads=2, shuffle=False))
    assert len(got) == len(ds) - 1
    assert all(np.isfinite(s["tgt_image"]).all() for s in got)


def test_depth_only_cli_trains_through_the_native_loader(colon_root, tmp_path):
    ckpt = str(tmp_path / "ck")
    state, last = depth_only.main([
        "--dataset_dir", colon_root, "--checkpoint_dir", ckpt, "--image_height", str(H),
        "--image_width", str(W), "--batch_size", "2", "--max_steps", "2",
        "--summary_freq", "1", "--validation_check", "100", "--save_latest_freq", "2",
        "--dtype", "float32", "--num_epochs", "4", "--native_loader", "--device", "cpu"])
    assert state.step == 2 and np.isfinite(last["total"])
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]


def test_native_loader_raises_where_it_cannot_build(colon_root, monkeypatch):
    """Without a compiler ``available()`` is False, ``build_error()`` says why, and
    ``--native_loader`` raises rather than fall back to the NumPy loader."""
    from tf_depth_estimation_torch.train.experiments.common import pair_loader

    saved = dict(native._STATE)
    monkeypatch.setattr(native, "_STATE", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert not native.available()
    assert "g++" in native.build_error()
    args = depth_only.parse_args(["--dataset_dir", colon_root, "--native_loader",
                                  "--device", "cpu"])
    with pytest.raises(RuntimeError, match=r"--native_loader needs the C\+\+ loader"):
        pair_loader(args, _dataset(colon_root), 2)
    monkeypatch.setattr(native, "_STATE", saved)
    assert native.available()
