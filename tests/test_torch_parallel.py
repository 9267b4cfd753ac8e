"""Data parallelism in the port against the JAX package: the 2-rank gloo step of config 2
(synced batch statistics, averaged gradients and metrics) against JAX's ``make_dp_step``
on a 2-device mesh and against the port's single-process step on the global batch; the
dry run's three phases at 2 ranks; the host-sharded loaders' index and seed streams; and
the sharded predictors.

The file starts one process group of 2 gloo ranks (``tests/torch_dp_worker.py``, over a
``FileStore`` in a temp directory), which runs the config-2 step and the dry run.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.infer.predictor import (
    DepthPredictor,
    TurboPredictor,
    _batched_apply,
)
from tf_depth_estimation_torch.losses.config import LossWeights
from tf_depth_estimation_torch.losses.pipelines import depth_only_loss
from tf_depth_estimation_torch.models import DispNet, DispNetVariant
from tf_depth_estimation_torch.models.turbo import TurboDepthNet, TurboVariant
from tf_depth_estimation_torch.parallel import make_dp_step, replica_devices, shard_batch
from tf_depth_estimation_torch.train.state import create_train_state
from tf_depth_estimation_torch.train.steps import make_depth_only_step, make_depth_only_val_step
from tf_depth_estimation_torch.utils.npz import _flatten, load_variables_npz, save_variables_npz
from tf_depth_estimation_torch.weights import module_variables
from torch_dp_worker import first_moments

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B, LR, WORLD = 32, 64, 4, 1e-3, 2
# the predictors' limits of tests/test_parallel.py:85-86
TOL_PREDICT = dict(rtol=2e-4, atol=1e-5)
# Adam's first moments after the step, (1 - beta1) times the gradient: each parameter's
# within this share of its largest moment. The parameters cannot tell gradients apart:
# Adam's first update moves each by lr * g / (|g| + eps), under lr whatever g is. The
# moments are compared from steps computed in float64 (the heads, and so the loss, stay
# float32 in both packages): at this size train-mode batch norm over 4 values in the
# deepest layers turns float32 rounding into gradients that differ by percents, JAX's
# own float32 and float64 steps too (test_float32_moments_differ_by_percents).
TOL_MOMENTS = 1e-5


def _batch():
    rng = np.random.RandomState(5)
    return {"tgt_image": rng.rand(B, H, W, 3).astype(np.float32),
            "label": rng.uniform(1.0, 2.0, (B, H, W, 1)).astype(np.float32)}


def _weights():
    return dataclasses.replace(LossWeights.depth_only(), height=H, width=W)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """From one JAX init of depth4 DispNet and one global batch of 4, each in float32 and
    computed in float64: JAX's DP step on a 2-device mesh, the port's 2-rank gloo DP step
    (and the dry run, in the same group), and the port's single-process step on the whole
    batch."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.losses.config import LossWeights as JLossWeights
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.parallel import make_dp_step as jdp
    from tf_depth_estimation_tpu.parallel import make_mesh
    from tf_depth_estimation_tpu.parallel import shard_batch as jshard
    from tf_depth_estimation_tpu.train.state import create_train_state as jcreate
    from tf_depth_estimation_tpu.train.steps import make_depth_only_step as jstep

    workdir = str(tmp_path_factory.mktemp("dp"))
    batch = _batch()
    with open(os.path.join(workdir, "cfg.json"), "w") as f:
        json.dump({"height": H, "width": W, "lr": LR}, f)
    np.savez(os.path.join(workdir, "batch.npz"), **batch)
    jstate = jcreate(JDispNet(JVariant.depth4(), dtype=jnp.float32),
                     jnp.zeros((B, H, W, 3)), learning_rate=LR)
    init = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    save_variables_npz(os.path.join(workdir, "init.npz"), init)
    # the ranks run while JAX compiles
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_dp_worker.py"),
                               str(r), str(WORLD), workdir], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    mesh = make_mesh(WORLD)
    jw = dataclasses.replace(JLossWeights.depth_only(), height=H, width=W)
    new, metrics = jdp(jstep(jw), mesh, donate_state=False)(jstate, jshard(batch, mesh))
    jax_out = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": _flatten(jax.tree.map(np.asarray, new.params)),
               "mu": _flatten(jax.tree.map(np.asarray, new.opt_state[0].mu)),
               "batch_stats": _flatten(jax.tree.map(np.asarray, new.batch_stats))}
    with jax.enable_x64(True):   # the same init and step, computed in float64
        j64 = jcreate(JDispNet(JVariant.depth4(), dtype=jnp.float64),
                      jnp.zeros((B, H, W, 3)), learning_rate=LR)
        j64 = j64.replace(params=jax.tree.map(jnp.asarray, init["params"]),
                          batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]))
        new64, _ = jdp(jstep(jw), mesh, donate_state=False)(j64, jshard(batch, mesh))
        jax_out["mu64"] = _flatten(jax.tree.map(np.asarray, new64.opt_state[0].mu))

    def single_step(dtype, part=batch):
        state = create_train_state(DispNet(DispNetVariant.depth4(), dtype=dtype),
                                   learning_rate=LR)
        state.load_variables(init)
        return make_depth_only_step(_weights())(
            state, {k: torch.from_numpy(v) for k, v in part.items()})

    single, s_metrics = single_step(torch.float32)
    single_out = {"metrics": {k: float(v) for k, v in s_metrics.items()},
                  "params": _flatten(single.variables()["params"]),
                  "mu": first_moments(single),
                  "mu64": first_moments(single_step(torch.float64)[0]),
                  # rank 0's half alone, its gradient not averaged with rank 1's
                  "half_mu64": first_moments(single_step(torch.float64,
                                                         shard_batch(batch, 0, WORLD))[0])}

    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)[-4000:]
    with open(os.path.join(workdir, "result.json")) as f:
        dp_out = json.load(f)
    dp_vars = load_variables_npz(os.path.join(workdir, "dp.npz"))[0]
    dp_out["params"] = _flatten(dp_vars["params"])
    dp_out["batch_stats"] = _flatten(dp_vars["batch_stats"])
    for key in ("mu", "mu64"):
        with np.load(os.path.join(workdir, f"dp_{key}.npz")) as f:
            dp_out[key] = {k: f[k] for k in f.files}
    return {"jax": jax_out, "dp": dp_out, "single": single_out, "init": init,
            "log": "\n".join(logs)}


def _params_within(got: dict, want: dict, atol: float):
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= atol, worst


def _moment_gap(got: dict, want: dict) -> float:
    """The largest over parameters of max|m - m_want| / max|m_want|."""
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
               for k in want)


def test_dp_step_matches_jax_make_dp_step(runs):
    """Loss rtol 2e-4 and every parameter within 2.5 lr of JAX's (the limits of
    tests/test_parallel.py:58-65), the running statistics as the single-process steps'
    (rtol 2e-4, atol 2e-5): JAX's partitioned batch norm takes its statistics over the
    whole batch of both devices, and so do the port's synced ones. Adam's first moments,
    the averaged gradients, of the float64 steps as optax's ``mu`` within ``TOL_MOMENTS``
    of each leaf's largest."""
    dp, ref = runs["dp"], runs["jax"]
    assert sorted(dp["metrics"]) == sorted(ref["metrics"]) == ["depth", "smooth", "total"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(dp["metrics"][k], v, rtol=2e-4, err_msg=k)
    _params_within(dp["params"], ref["params"], 2.5 * LR * (1 + 1e-4))
    assert sorted(dp["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(dp["batch_stats"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    gap = _moment_gap(dp["mu64"], ref["mu64"])
    assert gap <= TOL_MOMENTS, gap
    assert dp["step"] == 1


def test_dp_step_matches_the_single_process_step_on_the_global_batch(runs):
    """The 2-rank step and one process's step on all 4 samples: loss rtol 1e-5, every
    parameter within 2 lr (Adam's first step moves a near-zero gradient by ~lr of either
    sign), and Adam's first moments of the float64 steps, so the gradients, within
    ``TOL_MOMENTS``."""
    dp, single = runs["dp"], runs["single"]
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(dp["metrics"][k], v, rtol=1e-5, err_msg=k)
    _params_within(dp["params"], single["params"], 2 * LR * (1 + 1e-4))
    gap = _moment_gap(dp["mu64"], single["mu64"])
    assert gap <= TOL_MOMENTS, gap


def test_a_rank_s_own_gradient_would_miss_the_moment_limit(runs):
    """One process's float64 step on rank 0's half of the batch alone (its gradient not
    averaged with rank 1's): its first moments lie far beyond ``TOL_MOMENTS`` of the
    global step's, so the limit above tells averaged gradients from a rank's own."""
    gap = _moment_gap(runs["single"]["half_mu64"], runs["single"]["mu64"])
    assert gap > 100 * TOL_MOMENTS, gap


def test_float32_moments_differ_by_percents(runs):
    """Why the moments are held in float64: the float32 steps' first moments, port against
    JAX and 2 ranks against one process, lie a hundred times and more beyond the limit
    (float32 rounding amplified through train-mode batch norm over 4 values), JAX's own
    float32 step against its float64 one alike."""
    dp, ref, single = runs["dp"], runs["jax"], runs["single"]
    gaps = [_moment_gap(dp["mu"], ref["mu"]), _moment_gap(dp["mu"], single["mu"]),
            _moment_gap(ref["mu"], ref["mu64"])]
    print(f"first moments apart, float32: port vs JAX {gaps[0]:.3e}, 2 ranks vs one "
          f"process {gaps[1]:.3e}, JAX float32 vs float64 {gaps[2]:.3e}; float64: port vs "
          f"JAX {_moment_gap(dp['mu64'], ref['mu64']):.3e}, 2 ranks vs one process "
          f"{_moment_gap(dp['mu64'], single['mu64']):.3e}, rank 0's half vs the global "
          f"{_moment_gap(single['half_mu64'], single['mu64']):.3e}")
    assert min(gaps) > 100 * TOL_MOMENTS, gaps


def test_unsynced_batch_statistics_would_miss_the_limit(runs):
    """Each half of the batch through its own train-mode forward (per-rank statistics, as
    plain DistributedDataParallel keeps them): the mean of the two losses lies beyond
    2e-4 of the global loss, so the limit above tells synced statistics from unsynced."""
    w, batch = _weights(), _batch()
    halves = []
    for i in range(WORLD):
        model = DispNet(DispNetVariant.depth4()).train()
        create_train_state(model).load_variables(runs["init"])
        part = shard_batch(batch, i, WORLD)
        with torch.no_grad():
            outs = model.forward_nhwc(torch.from_numpy(part["tgt_image"]))
            halves.append(float(depth_only_loss(outs, torch.from_numpy(part["label"]),
                                                w)[0]))
    want = runs["single"]["metrics"]["total"]
    assert abs(np.mean(halves) - want) / want > 2e-4, (halves, want)


def test_dryrun_phases_at_two_ranks(runs):
    """The dry run's three phases over the 2 gloo ranks: finite global metrics, every rank
    the same parameters after each step, the checkpoint round trip bit-equal and the
    resumed step held to the live state's next one (``run_phases`` raises otherwise);
    on the CPU the two are equal, Adam's moments too."""
    out = runs["dp"]["dryrun"]
    assert out["world_size"] == WORLD and out["resumed_param_diff"] == 0.0
    assert out["resumed_moment_gap"] == 0.0
    assert all(np.isfinite(out[k]) for k in ("pairwise_total", "distill_total",
                                             "resumed_total")), out
    for phase in (1, 2, 3):
        assert f"dryrun_multichip({WORLD}): phase {phase} OK" in runs["log"]


def test_dp_step_refuses_a_step_whose_metrics_are_not_means(runs):
    """``si_log_rmse`` is a square root of means: the validation step cannot be averaged
    over shards, and ``make_dp_step`` refuses it (here and on the ranks)."""
    assert runs["dp"]["val_refused"]
    with pytest.raises(ValueError, match="si_log_rmse"):
        make_dp_step(make_depth_only_val_step(_weights()))


def test_shard_batch_slices_the_leading_axis_and_refuses_a_remainder():
    batch = {"x": np.arange(12).reshape(6, 2), "y": torch.arange(6)}
    parts = [shard_batch(batch, r, 3) for r in range(3)]
    assert [p["x"][:, 0].tolist() for p in parts] == [[0, 2], [4, 6], [8, 10]]
    assert [p["y"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, 0, 4)


# ---- host-sharded loaders ---------------------------------------------------------------

class _Indexed:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


class _Drawn:
    def sample(self, rng):
        return {"x": rng.rand(3)}


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_batch_loader_shards_as_jax(host_index, host_count):
    """One worker: the batches of host ``host_index`` of ``host_count`` (its
    ``RandomState(seed + host_index)`` shuffle, its slice of each epoch) equal JAX's,
    shuffled and in order."""
    from tf_depth_estimation_tpu.data.pipeline import BatchLoader as JBatchLoader

    from tf_depth_estimation_torch.data.pipeline import BatchLoader

    for shuffle in (True, False):
        kw = dict(batch_size=2, seed=7, num_epochs=3, num_workers=1, shuffle=shuffle,
                  host_index=host_index, host_count=host_count)
        got = [b["i"].tolist() for b in BatchLoader(_Indexed(), **kw)]
        want = [b["i"].tolist() for b in JBatchLoader(_Indexed(), **kw)]
        assert got == want and got, (shuffle, got, want)


@pytest.mark.parametrize("host_index", [0, 3])
def test_stream_loader_seeds_hosts_as_jax(host_index):
    """One worker: the draws of host ``host_index`` (seed * 1000003 + host * 9973 +
    worker) equal JAX's, bit for bit, and differ from host 0's."""
    from tf_depth_estimation_tpu.data.pipeline import StreamLoader as JStreamLoader

    from tf_depth_estimation_torch.data.pipeline import StreamLoader

    def first(cls, h):
        it = iter(cls(_Drawn(), batch_size=2, seed=5, num_workers=1, host_index=h))
        return np.stack([next(it)["x"] for _ in range(3)])

    got = first(StreamLoader, host_index)
    np.testing.assert_array_equal(got, first(JStreamLoader, host_index))
    if host_index:
        assert not np.array_equal(got, first(StreamLoader, 0))


# ---- sharded predictors -----------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """depth4 DispNet and TurboDepthNet ``small`` (seeded inits, as numpy trees) and 7
    frames: batch 4 and a ragged tail of 3, padded to 4."""
    g = torch.Generator().manual_seed(3)
    frames = np.random.RandomState(8).uniform(0, 255, (7, H, W, 3)).astype(np.float32)
    return {"depth4": module_variables(DispNet(DispNetVariant.depth4(), generator=g)),
            "small": module_variables(TurboDepthNet(TurboVariant.small(), generator=g)),
            "frames": frames}


@pytest.mark.parametrize("net", ["depth4", "small"])
def test_two_device_predictor_matches_one_device_and_jax(served, net):
    """``num_devices=2`` (on the CPU the two shards run in turn) against ``num_devices=1``
    and JAX's ``num_devices=2`` predictor on the 2-device mesh."""
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.infer.predictor import DepthPredictor as JDepth
    from tf_depth_estimation_tpu.infer.predictor import TurboPredictor as JTurbo
    from tf_depth_estimation_tpu.models import TurboVariant as JTurboVariant

    tree, frames = served[net], served["frames"]
    kw = dict(height=H, width=W, batch_size=4)
    if net == "depth4":
        port = lambda n: DepthPredictor(tree["params"], tree["batch_stats"], **kw,
                                        dtype=torch.float32, device="cpu", num_devices=n)
        ref = JDepth(tree["params"], tree["batch_stats"], **kw, dtype=jnp.float32,
                     num_devices=2)
    else:
        port = lambda n: TurboPredictor(tree["params"], tree["batch_stats"],
                                        variant=TurboVariant.small(), **kw,
                                        dtype=torch.float32, device="cpu", num_devices=n)
        ref = JTurbo(tree["params"], tree["batch_stats"], variant=JTurboVariant.small(),
                     **kw, dtype=jnp.float32, num_devices=2)
    two, one = port(2), port(1)
    assert two._min_chunk == 2 and two.num_devices == 2
    got = two.predict_array(frames)
    assert got.shape == (7, H, W)
    np.testing.assert_allclose(got, one.predict_array(frames), **TOL_PREDICT)
    np.testing.assert_allclose(got, ref.predict_array(frames), **TOL_PREDICT)


def test_tail_buckets_divide_by_min_chunk():
    """As ``tests/test_data.py:395-410`` holds JAX's: every padded tail divides by the
    device count, and every frame comes back once."""
    seen = []

    def fwd(x):
        seen.append(x.shape[0])
        return torch.zeros(x.shape[0], 4)

    outs = _batched_apply(fwd, np.zeros((23, 8, 8, 3), np.float32), 12, torch.device("cpu"),
                          min_chunk=6)
    assert sum(o.shape[0] for o in outs) == 23
    assert seen == [12, 12] and all(s % 6 == 0 for s in seen), seen
    with pytest.raises(ValueError, match="multiple of min_chunk"):
        _batched_apply(fwd, np.zeros((3, 8, 8, 3), np.float32), 10, torch.device("cpu"),
                       min_chunk=4)


def test_sharded_predictors_refuse_what_they_cannot_split(served):
    """A batch size that does not divide by the devices, and more devices than the machine
    has (here no GPU: JAX's ``make_mesh`` raises alike), raise before any weight moves."""
    tree = served["depth4"]
    with pytest.raises(ValueError, match="divide evenly"):
        DepthPredictor(tree["params"], tree["batch_stats"], height=H, width=W, batch_size=3,
                       dtype=torch.float32, device="cpu", num_devices=2)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"have {have}"):
        DepthPredictor(tree["params"], tree["batch_stats"], height=H, width=W, batch_size=4,
                       device="cuda", num_devices=have + 1)
    with pytest.raises(ValueError, match=f"have {have}"):
        replica_devices("cuda", have + 1)
    assert replica_devices("cpu", 3) == [torch.device("cpu")] * 3


# ---- experiment configurations ----------------------------------------------------------

@pytest.mark.parametrize("name", ["depth_only", "depth_then_cam", "optflow_combine",
                                  "on_demon", "split_training"])
def test_experiment_config_presets_equal_jaxs(name):
    """Every field of each preset, its ``LossWeights`` field by field, equals JAX's; the
    one difference is the port's chosen sampler preset for config 3 (``"fused"``, where
    JAX keeps ``"xla"``; ROADMAP, "Sampler presets")."""
    from tf_depth_estimation_tpu.train.config import ExperimentConfig as JConfig

    from tf_depth_estimation_torch.train.config import ExperimentConfig

    got = getattr(ExperimentConfig, name)(num_devices=2, seed=3)
    want = getattr(JConfig, name)(num_devices=2, seed=3)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        if f.name != "weights":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    gw, ww = dataclasses.asdict(got.weights), dataclasses.asdict(want.weights)
    assert sorted(gw) == sorted(ww)
    differ = {k: (gw[k], ww[k]) for k in ww if gw[k] != ww[k]}
    assert differ == ({"sampler": ("fused", "xla")} if name == "depth_then_cam" else {})
