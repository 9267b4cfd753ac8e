"""The grouped samplers, ``bilinear_sample_group`` and ``bilinear_sample_fused_group``: on the
CPU (the plain version member by member) each member against JAX's kernels run as the JAX
tests run them (``_sample_banded(..., interpret=True)`` and the VJP of
``bilinear_sample_tpu`` in interpret mode; ``pallas_warp.bilinear_sample_fused(...,
interpret=True)`` and its gradient) and against the single-call plain version. The groups
mix sizes, members that do and do not need dcoords, one that needs dimgs, two warps of one
image, views and NaN / infinite coords; the cap on members and the routing by sampler name
are held too. The ``cuda`` tests hold the group kernels to the plain version on the card:
one launch each way a route, out and wmask bit-equal, dcoords the same bits twice, two
groups on two streams at once.

JAX is imported inside the fixtures that use it: the GPU machine has no JAX, and runs the
``cuda`` tests of this file with ``pytest -m cuda --noconftest``.
"""
import numpy as np
import pytest
import torch

from tf_depth_estimation_torch.geometry import warp
from tf_depth_estimation_torch.geometry.sampling import bilinear_sample_group as routed_group
from tf_depth_estimation_torch.ops import bilinear_sample as bs
from tf_depth_estimation_torch.ops import bilinear_sample_fused as bsf

# tests/test_pallas_sample.py's limits on images in [0, 1] (tests/test_torch_sampling.py)
TOL_FWD = dict(rtol=1e-6, atol=1e-6)
TOL_VJP = dict(rtol=1e-5, atol=1e-5)


def _coords(rng, B, H, W, kind):
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.broadcast_to(np.stack([gx, gy], -1)[None], (B, H, W, 2)).astype(np.float32)
    if kind == "jitter":
        return grid + rng.randn(B, H, W, 2).astype(np.float32) * 3.0
    if kind == "border":        # straddling every border
        c = grid + np.array([-2.5, 2.5], np.float32)
        c[:, :2, :, 1] -= 5.0
        c[:, :, -3:, 0] += 4.25
        return c
    if kind == "wild":          # far outside the image as well as inside
        return (rng.rand(B, H, W, 2) * np.array([W * 4.0, H * 4.0])
                - 2.0 * np.array([W, H])).astype(np.float32)
    c = rng.uniform(-2, max(H, W) + 2, (B, H, W, 2)).astype(np.float32)     # "nonfinite"
    c.reshape(-1)[rng.choice(c.size, 30, replace=False)] = np.repeat(
        [np.nan, np.inf, -np.inf], 10)
    return c


# the #4 group: (name, image index, B, H, W, C, coords kind, needs dimgs, needs dcoords);
# members 0 and 1 sample one image (a GT and a predicted warp), member 3 comes as views
MEMBERS = [("jitter", 0, 2, 16, 24, 3, "jitter", False, True),
           ("same image, no gradient", 0, 2, 16, 24, 3, "jitter", False, False),
           ("border, dimgs", 1, 1, 8, 12, 1, "border", True, True),
           ("wild, views", 2, 2, 16, 40, 2, "wild", False, True),
           ("NaN and inf", 3, 2, 8, 16, 3, "nonfinite", False, True)]


def _members(seed=0):
    """(images, [(image index, coords) per member]) as numpy float32, images in [0, 1]."""
    rng = np.random.RandomState(seed)
    shapes = {}
    for _, k, B, H, W, C, *_ in MEMBERS:
        shapes[k] = (B, H, W, C)
    images = [rng.rand(*shapes[k]).astype(np.float32) for k in sorted(shapes)]
    return images, [(k, _coords(rng, B, H, W, kind))
                    for _, k, B, H, W, _, kind, _, _ in MEMBERS]


def _cotangents(seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, W, C).astype(np.float32), rng.randn(B, H, W, 1).astype(np.float32))
            for _, _, B, H, W, C, *_ in MEMBERS]


def _torch_members(images, members):
    """(imgs, coords, leaves) as the group takes them: each image a tensor (a leaf that
    needs a gradient where a member asks for dimgs), each coords a leaf where its member
    asks for dcoords; member 3's image and coords as non-contiguous views."""
    need_img = {k: any(m[7] for m in MEMBERS if m[1] == k) for k in range(len(images))}
    img_leaves = [torch.from_numpy(a.copy()).requires_grad_(need_img[k])
                  for k, a in enumerate(images)]
    imgs, coords, leaves = [], [], []
    for (name, k, *_, need_c), (_, c) in zip(MEMBERS, members):
        c_leaf = torch.from_numpy(c.copy()).requires_grad_(need_c)
        i, cc = img_leaves[k], c_leaf
        if name.endswith("views"):
            i = i.transpose(1, 2).contiguous().transpose(1, 2)
            cc = torch.stack([c_leaf[..., 0], c_leaf[..., 1]], 0).permute(1, 2, 3, 0)
            assert not i.is_contiguous() and not cc.is_contiguous()
        imgs.append(i)
        coords.append(cc)
        leaves.append(c_leaf)
    return imgs, coords, leaves, img_leaves


def _run(group_fn, images, members):
    """The group's outputs and, after a backward at the seeded cotangents, each member's
    dcoords (or None) and each image's dimgs (or None)."""
    imgs, coords, leaves, img_leaves = _torch_members(images, members)
    outs, wmasks = group_fn(imgs, coords)
    tensors, cots = [], []
    for o, w, (dout, dmask), m in zip(outs, wmasks, _cotangents(), MEMBERS):
        if m[7] or m[8]:
            tensors += [o, w]
            cots += [torch.from_numpy(dout), torch.from_numpy(dmask)]
    torch.autograd.backward(tensors, cots)
    return ([o.detach() for o in outs], [w.detach() for w in wmasks],
            [c.grad for c in leaves], [i.grad for i in img_leaves])


@pytest.fixture(scope="module")
def jax_members():
    """Each member through JAX's #4 kernel in interpret mode, as
    ``tests/test_pallas_sample.py`` runs it: the forward and the VJP of
    ``bilinear_sample_tpu`` at the member's cotangents, jitted once a shape."""
    import jax
    import jax.numpy as jnp
    from test_pallas_sample import pltpu_interpret

    from tf_depth_estimation_tpu.ops.pallas_sample import bilinear_sample_tpu

    def fwd_vjp(imgs, coords, dout, dmask):
        primal, vjp = jax.vjp(bilinear_sample_tpu, imgs, coords)
        return primal, vjp((dout, dmask))

    run = jax.jit(fwd_vjp)
    images, members = _members()
    fwd, vjps = [], []
    with pltpu_interpret():
        for (k, c), (dout, dmask) in zip(members, _cotangents()):
            (out, mask), (di, dc) = run(*(jnp.asarray(a) for a in (images[k], c, dout, dmask)))
            fwd.append((np.asarray(out), np.asarray(mask)))
            vjps.append((np.asarray(di), np.asarray(dc)))
    return fwd, vjps


@pytest.fixture(scope="module")
def port_group():
    images, members = _members()
    return _run(bs.bilinear_sample_group, images, members)


@pytest.mark.parametrize("k", range(len(MEMBERS)), ids=[m[0] for m in MEMBERS])
def test_group_forward_matches_jax_kernel_and_single_calls(k, jax_members, port_group):
    images, members = _members()
    idx, c = members[k]
    ref_out, ref_mask = jax_members[0][k]
    out, mask = port_group[0][k], port_group[1][k]
    np.testing.assert_allclose(out.numpy(), ref_out, **TOL_FWD)
    np.testing.assert_allclose(mask.numpy(), ref_mask, **TOL_FWD)
    single = bs.bilinear_sample_reference(torch.from_numpy(images[idx]), torch.from_numpy(c))
    for got, want in zip((out, mask), single):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("k", [k for k, m in enumerate(MEMBERS) if m[7] or m[8]],
                         ids=[m[0] for m in MEMBERS if m[7] or m[8]])
def test_group_gradients_match_jax_vjp_and_single_calls(k, jax_members, port_group):
    """dcoords of every member that asks for it, and dimgs of the image one member asks
    for, against the VJP of JAX's kernel and autograd of the single-call plain version;
    a member that asks for nothing has no gradient."""
    images, members = _members()
    _, _, dcoords, dimgs = port_group
    ref_di, ref_dc = jax_members[1][k]
    idx, c = members[k]
    np.testing.assert_allclose(dcoords[k].numpy(), ref_dc, **TOL_VJP)
    ti = torch.from_numpy(images[idx].copy()).requires_grad_(MEMBERS[k][7])
    tc = torch.from_numpy(c.copy()).requires_grad_(True)
    dout, dmask = _cotangents()[k]
    torch.autograd.backward(list(bs.bilinear_sample_reference(ti, tc)),
                            [torch.from_numpy(dout), torch.from_numpy(dmask)])
    assert torch.equal(dcoords[k], tc.grad)
    if MEMBERS[k][7]:
        np.testing.assert_allclose(dimgs[idx].numpy(), ref_di, **TOL_VJP)
        assert torch.equal(dimgs[idx], ti.grad)
    assert [d is None for d in dcoords] == [not m[8] for m in MEMBERS]
    assert [d is None for d in dimgs] == [True, False, True, True]


# the #5 group: (B, Hs, Ws, Ht, Wt, C), inside JAX's rule (B % 8 == 0, a same-product
# warp) but for the last member, which JAX and the port send to the plain sampler
FUSED = [(8, 8, 16, 8, 16, 1), (8, 16, 24, 24, 16, 3), (2, 8, 8, 8, 8, 1)]


def _fused_members(seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, Hs, Ws, C).astype(np.float32),
             rng.uniform(-3, max(Hs, Ws) + 3, (B, Ht, Wt, 2)).astype(np.float32))
            for B, Hs, Ws, Ht, Wt, C in FUSED]


@pytest.fixture(scope="module")
def jax_fused():
    """Each member through JAX's ``bilinear_sample_fused`` (its kernel in interpret mode,
    or its plain fallback), as ``tests/test_pallas.py`` runs it: (out, mask, d/d imgs,
    d/d coords of sum(out ** 2)), jitted once a shape."""
    import jax
    import jax.numpy as jnp

    from tf_depth_estimation_tpu.ops.pallas_warp import bilinear_sample_fused

    def fwd_grad(imgs, coords):
        out, mask = bilinear_sample_fused(imgs, coords, True)
        grads = jax.grad(lambda a, b: jnp.sum(bilinear_sample_fused(a, b, True)[0] ** 2),
                         argnums=(0, 1))(imgs, coords)
        return out, mask, *grads

    run = jax.jit(fwd_grad)
    return [tuple(np.asarray(x) for x in run(jnp.asarray(i), jnp.asarray(c)))
            for i, c in _fused_members()]


def test_fused_group_matches_jax_and_single_calls(jax_fused):
    """Every member's out, wmask and both gradients of sum_k sum(out_k ** 2) against JAX's
    ``bilinear_sample_fused`` and against the single-call plain version; no launch on the
    CPU."""
    members = _fused_members()
    leaves = [(torch.from_numpy(i).requires_grad_(True),
               torch.from_numpy(c).requires_grad_(True)) for i, c in members]
    before = (bsf.bilinear_sample_fused.launches, bs.bilinear_sample.launches)
    outs, masks = bsf.bilinear_sample_fused_group([i for i, _ in leaves],
                                                  [c for _, c in leaves])
    sum(o.pow(2).sum() for o in outs).backward()
    assert (bsf.bilinear_sample_fused.launches, bs.bilinear_sample.launches) == before
    for (ti, tc), o, m, (ro, rm, rgi, rgc), (i, c) in zip(leaves, outs, masks, jax_fused,
                                                          members):
        np.testing.assert_allclose(o.detach().numpy(), ro, atol=TOL_FWD["atol"])
        np.testing.assert_allclose(m.detach().numpy(), rm, atol=TOL_FWD["atol"])
        np.testing.assert_allclose(ti.grad.numpy(), rgi, atol=TOL_VJP["atol"])
        np.testing.assert_allclose(tc.grad.numpy(), rgc, atol=TOL_VJP["atol"])
        si, sc = torch.from_numpy(i).requires_grad_(True), torch.from_numpy(c).requires_grad_(True)
        so, sm = bs.bilinear_sample_reference(si, sc)
        so.pow(2).sum().backward()
        assert torch.equal(o, so) and torch.equal(m, sm)
        assert torch.equal(ti.grad, si.grad) and torch.equal(tc.grad, sc.grad)


@pytest.mark.parametrize("sampler", ["xla", "pallas", "fused"])
def test_routing_by_sampler_name(sampler):
    """``geometry/sampling.py``'s group gives what its single call gives, member by
    member; on the CPU every name is the plain version and launches nothing."""
    from tf_depth_estimation_torch.geometry.sampling import bilinear_sample as routed

    members = [(torch.from_numpy(i), torch.from_numpy(c)) for i, c in _fused_members()]
    before = (bsf.bilinear_sample_fused.launches, bs.bilinear_sample.launches)
    outs, masks = routed_group([i for i, _ in members], [c for _, c in members], sampler)
    for (i, c), o, m in zip(members, outs, masks):
        ro, rm = routed(i, c, sampler=sampler)
        assert torch.equal(o, ro) and torch.equal(m, rm)
    assert (bsf.bilinear_sample_fused.launches, bs.bilinear_sample.launches) == before
    with pytest.raises(ValueError):
        routed_group([members[0][0]], [members[0][1]], "grid_sample")


@pytest.mark.parametrize("group", [bs.bilinear_sample_group, bsf.bilinear_sample_fused_group],
                         ids=["bilinear_sample_group", "bilinear_sample_fused_group"])
@pytest.mark.parametrize("case", ["past the cap", "no member", "lists differ", "f64 member"])
def test_groups_refuse_what_the_kernels_do_not_take(group, case):
    x = torch.zeros(1, 8, 8, 1)
    c = torch.zeros(1, 8, 8, 2)
    n = bs.MAX_MEMBERS + 1
    bad = {"past the cap": ([x] * n, [c] * n), "no member": ([], []),
           "lists differ": ([x, x], [c]), "f64 member": ([x, x.double()], [c, c])}[case]
    with pytest.raises((ValueError, TypeError)):
        group(*bad)


def test_warp_coordinate_helpers_are_the_warps_own():
    """``projective_coords`` and ``flow_coords``, which the pipelines call before one group
    call, give the coordinates the warps sample at."""
    rng = np.random.RandomState(3)
    B, H, W = 2, 8, 12
    img = torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.8, 2.5, (B, H, W)).astype(np.float32))
    pose = torch.from_numpy(rng.uniform(-0.05, 0.05, (B, 6)).astype(np.float32))
    K = torch.tensor([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]]).expand(B, 3, 3)
    res = warp.projective_inverse_warp(img, depth, pose, K.contiguous(), fmt="euler")
    coords, warped_depth, mat = warp.projective_coords(depth, pose, K.contiguous(), "euler")
    assert torch.equal(coords, res.coords) and torch.equal(warped_depth, res.warped_depth)
    assert torch.equal(mat, res.pose)
    fx, fy = (torch.from_numpy(rng.randn(B, H, W, 1).astype(np.float32)) for _ in range(2))
    out = bs.bilinear_sample_reference(img, warp.flow_coords(fx, fy))[0]
    assert torch.equal(out, warp.flow_warp(img, fx, fy))


def test_every_kernel_variant_still_applies():
    """``tools/sampler_variants.py`` patches ``csrc/bilinear_sample.cu`` by text: each
    patch's text is still in the source."""
    import os

    from tf_depth_estimation_torch.ops import _build
    from tf_depth_estimation_torch.tools.sampler_variants import VARIANTS

    for name, patches in VARIANTS.items():
        for f, old, _ in patches:
            with open(os.path.join(_build.CSRC, f)) as fh:
                assert old in fh.read(), (name, old)


# ---- on the card -----------------------------------------------------------------------

# dcoords and dimgs against autograd of the plain version on images in [0, 255]: the same
# terms summed in another order (chip_smoke.py TOL_DCOORDS)
TOL_CUDA_GRAD = dict(rtol=1e-5, atol=1e-5 * 255)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _step_group(dev, B=2, H=32, W=48, seed=0):
    """A config-4 step's 12 warps at H x W: per scale one image in [0, 255] and three
    coords (a GT warp with no gradient, a predicted and a flow warp, leaves)."""
    rng = np.random.RandomState(seed)
    imgs, coords = [], []
    for s in range(4):
        h, w = H >> s, W >> s
        img = torch.from_numpy((rng.rand(B, h, w, 3) * 255).astype(np.float32)).to(dev)
        for g in (False, True, True):
            c = torch.from_numpy(_coords(rng, B, h, w, "jitter")).to(dev)
            imgs.append(img)
            coords.append(c.requires_grad_(g))
    return imgs, coords


def _step_run(imgs, coords, group=bs.bilinear_sample_group):
    outs, masks = group(imgs, coords)
    grads = [c for c in coords if c.requires_grad]
    rng = np.random.RandomState(9)
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(o.device)
            for o, c in zip(outs, coords) if c.requires_grad]
    dc = torch.autograd.grad([o for o, c in zip(outs, coords) if c.requires_grad], grads, cots)
    return [o.detach() for o in outs], [m.detach() for m in masks], dc


def _plain_run(imgs, coords):
    return _step_run(imgs, coords, group=bs.plain_group)


@pytest.mark.cuda
def test_cuda_step_group_launches_once_each_way_and_matches_plain():
    dev = _cuda()
    imgs, coords = _step_group(dev)
    before = (bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches,
              bs.bilinear_sample_reference.calls)
    got = _step_run(imgs, coords)
    torch.cuda.synchronize()
    assert (bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches,
            bs.bilinear_sample_reference.calls) == (before[0] + 1, before[1] + 1, before[2])
    again = _step_run(imgs, coords)
    assert all(torch.equal(a, b) for a, b in zip(got[2], again[2]))
    ref = _plain_run(imgs, coords)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        assert torch.equal(g, r)
    for g, r in zip(got[2], ref[2]):
        torch.testing.assert_close(g, r, **TOL_CUDA_GRAD)


@pytest.mark.cuda
def test_cuda_group_dimgs_and_wmask_cotangent_match_plain():
    """A group whose images need a gradient, with cotangents for out and wmask: dimgs
    (atomics) and dcoords within the limit of autograd of the plain version."""
    dev = _cuda()
    imgs, coords = _step_group(dev, seed=1)
    leaves = [i.clone().requires_grad_(True) for i in imgs[::3]]
    grads = []
    for group in (bs.bilinear_sample_group, bs.plain_group):
        ims = [leaves[k // 3] for k in range(len(imgs))]
        cs = [c.detach().requires_grad_(True) for c in coords]
        outs, masks = group(ims, cs)
        rng = np.random.RandomState(4)
        cots = [torch.from_numpy(rng.randn(*t.shape).astype(np.float32)).to(dev)
                for t in outs + masks]
        grads.append(torch.autograd.grad(outs + masks, leaves + cs, cots))
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, **TOL_CUDA_GRAD)


@pytest.mark.cuda
def test_cuda_fused_group_with_a_member_outside_the_rule():
    """Members inside JAX's rule make one launch each way on the fused route, the one
    outside it one on the sampler's route; out and wmask bit-equal to the plain version."""
    dev = _cuda()
    members = [(torch.from_numpy(i * 255).to(dev),
                torch.from_numpy(c).to(dev).requires_grad_(True)) for i, c in _fused_members()]
    before = (bsf.bilinear_sample_fused.launches, bsf.bilinear_sample_fused.backward_launches,
              bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches)
    outs, masks = bsf.bilinear_sample_fused_group([i for i, _ in members],
                                                  [c for _, c in members])
    rng = np.random.RandomState(8)
    cots = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(dev) for o in outs]
    got = torch.autograd.grad(outs, [c for _, c in members], cots)
    torch.cuda.synchronize()
    after = (bsf.bilinear_sample_fused.launches, bsf.bilinear_sample_fused.backward_launches,
             bs.bilinear_sample.launches, bs.bilinear_sample.backward_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)
    for (i, c), o, m, g, cot in zip(members, outs, masks, got, cots):
        tc = c.detach().requires_grad_(True)
        ro, rm = bs.bilinear_sample_reference(i, tc)
        assert torch.equal(o, ro) and torch.equal(m, rm)
        torch.testing.assert_close(g, torch.autograd.grad(ro, tc, cot)[0], **TOL_CUDA_GRAD)


@pytest.mark.cuda
def test_cuda_groups_on_two_streams_at_once():
    """Two step groups, each on its own stream without a synchronisation between them,
    five times: every result has the bits of the group run alone."""
    dev = _cuda()
    imgs, coords = _step_group(dev)
    alone = _step_run(imgs, coords)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        for st in streams:
            with torch.cuda.stream(st):
                runs.append(_step_run(imgs, coords))
    torch.cuda.synchronize()
    for r in runs:
        assert all(torch.equal(a, b) for a, b in zip(r[0] + r[1] + list(r[2]),
                                                     alone[0] + alone[1] + list(alone[2])))


@pytest.mark.cuda
def test_cuda_group_refuses_past_the_cap_and_launches_nothing():
    dev = _cuda()
    x, c = torch.ones(1, 8, 8, 1, device=dev), torch.zeros(1, 8, 8, 2, device=dev)
    before = bs.bilinear_sample.launches
    with pytest.raises(ValueError):
        bs.bilinear_sample_group([x] * (bs.MAX_MEMBERS + 1), [c] * (bs.MAX_MEMBERS + 1))
    assert bs.bilinear_sample.launches == before
    bs._lib()   # the kernel's own cap is the wrapper's
