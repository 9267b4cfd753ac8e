"""``data/device_cache.py`` against the JAX package's: ``gather_batch`` bit for bit (uint8
images cast at the gather, float labels, per-sample mirror and rot180 bits) and
``index_stream`` draw for draw, and the cache's own checks, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_depth_estimation_tpu.data.device_cache import DeviceCache as JDeviceCache
from tf_depth_estimation_tpu.data.device_cache import gather_batch as jgather_batch
from tf_depth_estimation_torch.data.device_cache import DeviceCache, gather_batch

N, H, W = 7, 6, 10


def _corpus(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (N, H, W, 3), np.uint8),
            "label": rng.uniform(0.5, 3, (N, H, W, 1)).astype(np.float32),
            "pose": rng.randn(N, 6).astype(np.float32)}


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("keys", [(("image",), ("image", "label")), ((), ("image",)),
                                  (("image",), ())])
def test_gather_batch_is_jax_gather_bit_for_bit(augment, keys):
    float_keys, aug_keys = keys
    data = _corpus()
    cache = DeviceCache(data, float_keys, aug_keys, device="cpu")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    for idx, flip, rot in cache.index_stream(5, seed=1, augment=augment, num_steps=4):
        got = gather_batch(cache.data, idx, float_keys=float_keys, aug_keys=aug_keys,
                           flip=flip, rot=rot)
        want = jgather_batch(jdata, jnp.asarray(idx), float_keys=float_keys,
                             aug_keys=aug_keys, flip=jnp.asarray(flip), rot=jnp.asarray(rot))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        bound = cache.gather(idx, flip=flip, rot=rot)
        assert all(torch.equal(bound[k], got[k]) for k in got)


def test_gather_without_bits_takes_rows_as_they_are():
    data = _corpus(2)
    cache = DeviceCache(data, ("image",), ("image",), device="cpu")
    got = cache.gather(np.array([3, 0, 3]))
    np.testing.assert_array_equal(got["image"].numpy(),
                                  data["image"][[3, 0, 3]].astype(np.float32))


@pytest.mark.parametrize("augment", [True, False])
def test_index_stream_is_jax_stream(augment):
    data = _corpus()
    ours = DeviceCache(data, device="cpu").index_stream(4, seed=7, augment=augment,
                                                       num_steps=5)
    theirs = JDeviceCache(data).index_stream(4, seed=7, augment=augment, num_steps=5)
    pairs = list(zip(ours, theirs))
    assert len(pairs) == 5
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_cache_holds_uint8_and_refuses_a_ragged_corpus():
    data = _corpus()
    cache = DeviceCache(data, device="cpu")
    assert cache.data["image"].dtype == torch.uint8 and cache.num_samples == N
    assert cache.nbytes() == JDeviceCache(data).nbytes() == sum(v.nbytes
                                                                 for v in data.values())
    with pytest.raises(ValueError, match="ragged"):
        DeviceCache({"image": data["image"], "label": data["label"][:3]}, device="cpu")
