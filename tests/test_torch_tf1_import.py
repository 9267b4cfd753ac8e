"""The port's TF1 importer against the JAX package's: one synthetic TF1 checkpoint under
the reference's slim names (written as ``tests/test_tf1_import.py`` writes it), imported
by both; the names, the values, both eval forwards, the shape check and the CLI."""
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tf_depth_estimation_torch.models import DispNet, DispNetVariant  # noqa: E402
from tf_depth_estimation_torch.models.depth_pose import DepthPoseNet  # noqa: E402
from tf_depth_estimation_torch.train import tf1_import  # noqa: E402
from tf_depth_estimation_torch.train.checkpoint import load_latest_variables  # noqa: E402
from tf_depth_estimation_torch.weights import load_variables  # noqa: E402
from torch_fixtures import drop_tmp_path  # noqa: F401,E402 (autouse)

H, W = 32, 64
TOL = dict(rtol=2e-4, atol=2e-4)
SCOPES = {"dispnet": "depth_net", "depth_pose": "model_pairdepth/depth_cam_net"}


def _write_tf1_checkpoint(directory, jax_variables, arch, scope):
    """One TF1 variable per leaf of the JAX tree, seeded values through
    ``tf.compat.v1.train.Saver``: variances positive, and each kernel at He's scale,
    sqrt(2 / fan-in), as a trained net's would be. (``tests/test_tf1_import.py`` scales
    every kernel by 0.05, which only keeps the forward finite: DepthPoseNet's pose then
    reaches ~500 and both packages' float32 forwards lie ~6.5e-4 from the float64 one, so
    a 2e-4 comparison would measure that conditioning, not the packages.)"""
    import jax

    from tf_depth_estimation_tpu.train.tf1_import import tf1_name_for as jname

    rng = np.random.RandomState(0)
    values = {}
    graph = tf.Graph()
    with graph.as_default():
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(jax_variables)[0]:
            path = tuple(k.key for k in keypath)
            name = jname(path, arch, scope)
            val = rng.randn(*leaf.shape).astype(np.float32)
            if name.endswith("moving_variance"):
                val = np.abs(val) + 0.1
            elif name.endswith("weights"):
                val *= np.sqrt(2.0 / np.prod(val.shape[:-1]))
            values[name] = val
            tf.compat.v1.get_variable(name, initializer=tf.constant(val))
        saver = tf.compat.v1.train.Saver()
        prefix = str(directory / "model.ckpt")
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, prefix)
    return prefix, values


@pytest.fixture(scope="module", params=sorted(SCOPES))
def imported(request, tmp_path_factory):
    """(arch, the port's tree and paths, JAX's tree and paths, the checkpoint's values
    and prefix) for one architecture."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.models import DepthPoseNet as JDepthPoseNet
    from tf_depth_estimation_tpu.models import DispNet as JDispNet
    from tf_depth_estimation_tpu.models import DispNetVariant as JVariant
    from tf_depth_estimation_tpu.train.tf1_import import import_tf1_variables as jimport
    from tf_depth_estimation_tpu.train.tf1_import import read_tf1_checkpoint as jread

    arch, scope = request.param, SCOPES[request.param]
    jmodel = (JDispNet(JVariant.depth4(), dtype=jnp.float32) if arch == "dispnet"
              else JDepthPoseNet(dtype=jnp.float32))
    x = jnp.zeros((1, H, W, 3 if arch == "dispnet" else 6))
    jvars = jax.jit(lambda k: jmodel.init(k, x, train=True))(jax.random.PRNGKey(0))
    prefix, values = _write_tf1_checkpoint(tmp_path_factory.mktemp(arch), jvars, arch, scope)
    tf1_vars = tf1_import.read_tf1_checkpoint(prefix)
    jtree, jpaths = jimport(jread(prefix), jvars, arch, scope)
    tree, paths = tf1_import.import_tf1_variables(tf1_vars, tf1_import.init_variables(arch),
                                                  arch, scope)
    return {"arch": arch, "scope": scope, "tree": tree, "paths": paths,
            "jtree": jax.tree.map(np.asarray, jtree), "jmodel": jmodel,
            "jpaths": [tuple(k.key for k in p) for p in jpaths], "values": values,
            "prefix": prefix, "tf1_vars": tf1_vars}


def test_names_and_values_equal_jaxs(imported):
    """The port's tree maps every leaf to the slim name JAX maps it to, in the same order,
    and each leaf holds that name's checkpoint value."""
    arch, scope = imported["arch"], imported["scope"]
    names = [tf1_import.tf1_name_for(p, arch, scope) for p in imported["paths"]]
    assert names == [tf1_import.tf1_name_for(p, arch, scope) for p in imported["jpaths"]]
    assert sorted(names) == sorted(imported["values"])
    for path, name in zip(imported["paths"], names):
        leaf = imported["tree"]
        for k in path:
            leaf = leaf[k]
        np.testing.assert_array_equal(leaf, imported["values"][name])


def test_eval_forwards_agree_with_jax(imported):
    """Both packages' eval forwards of the imported weights on one seeded input: every
    output within rtol = atol = 2e-4."""
    import jax.numpy as jnp

    arch = imported["arch"]
    c = 3 if arch == "dispnet" else 6
    x = np.random.RandomState(1).uniform(-0.5, 0.5, (2, H, W, c)).astype(np.float32)
    model = DispNet(DispNetVariant.depth4()) if arch == "dispnet" else DepthPoseNet()
    load_variables(model, imported["tree"])
    with torch.no_grad():
        got = model.eval().forward_nhwc(torch.from_numpy(x))
    want = imported["jmodel"].apply(imported["jtree"], jnp.asarray(x), train=False)
    if arch == "dispnet":
        pairs = list(zip(got, want))
    else:   # (disparities, pose, masks)
        pairs = list(zip(got[0], want[0])) + [(got[1], want[1])]
    for g, r in pairs:
        g = g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), **TOL)


def test_a_shape_mismatch_raises(imported):
    tf1_vars = dict(imported["tf1_vars"])
    name = f"{imported['scope']}/cnv1/weights"
    tf1_vars[name] = np.zeros((3, 3, 3, 7), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tf1_import.import_tf1_variables(tf1_vars, tf1_import.init_variables(imported["arch"]),
                                        imported["arch"], imported["scope"])
    del tf1_vars[name]
    with pytest.raises(KeyError, match="not in the checkpoint"):
        tf1_import.import_tf1_variables(tf1_vars, tf1_import.init_variables(imported["arch"]),
                                        imported["arch"], imported["scope"])


def test_cli_writes_the_ports_checkpoint_directory(imported, tmp_path):
    """``python -m tf_depth_estimation_torch.train.tf1_import PREFIX --arch ... --out C
    --group G`` writes ``C/G-0.npz``, which ``load_latest_variables`` reads back as the
    imported tree."""
    arch = imported["arch"]
    tf1_import.main([imported["prefix"], "--arch", arch, "--scope", imported["scope"],
                     "--out", str(tmp_path / "ck"), "--group", "imported"])
    variables, step = load_latest_variables(str(tmp_path / "ck"), "imported")
    assert step == 0
    for path in imported["paths"]:
        a, b = variables, imported["tree"]
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)
