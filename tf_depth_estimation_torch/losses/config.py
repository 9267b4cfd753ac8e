"""Loss-weight tables: typed replacements of the reference's post-parse FLAGS blocks.

The port's copy of ``tf_depth_estimation_tpu/losses/config.py`` (plain data): every
reference experiment differs only in these constants, and the classmethods reproduce each
entry point's block. ``sampler`` takes the JAX package's names; in the port ``"pallas"``
selects the hand-written CUDA sampler (``ops/bilinear_sample.py``), ``"fused"`` the same
kernels under the fused warp's eligibility rule (``ops/bilinear_sample_fused.py``) and ``"xla"`` the plain PyTorch sampler
(``geometry/sampling.py``). Five presets differ from the JAX package's, in that field
alone: ``depth_then_cam()`` takes ``"fused"``, and ``depth_then_cam_lr()``,
``gtdepth_gtcam()``, ``dim11()`` and ``only_image()`` take ``"pallas"``, where JAX keeps
``"xla"``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Weight table + geometry shared by all loss pipelines."""

    height: int
    width: int
    num_scales: int = 4
    max_steps: int = 200_000
    # warp sampler: "pallas" / "fused" = the port's CUDA kernels, "xla" = the plain version
    sampler: str = "xla"

    smooth_weight: float = 1.0
    data_weight: float = 0.0
    optflow_weight: float = 0.0
    depth_weight: float = 1.0
    depth_sig_weight: float = 0.0
    explain_reg_weight: float = 0.0
    cam_weight_rot: float = 0.0
    cam_weight_tran: float = 0.0
    depth_weight_consist: float = 0.0
    # L/R-symmetric family extras
    cam_weight: float = 0.0           # full-4x4 pose MSE (train_depth_then_cam_lr.py:44)
    cam_consist_weight: float = 0.0   # defined but inactive at HEAD (commented block)
    consist_weight: float = 0.0       # gtdepth_gtcam consistency weight
    sig_depth_weight: float = 0.0     # un-ramped 5-delta sig weight (gtdepth_gtcam)

    @classmethod
    def depth_only(cls) -> "LossWeights":
        """``train_depth_only.py:33-40`` — 240x720 colon pairs (BASELINE config 2)."""
        return cls(height=240, width=720, max_steps=20_000,
                   smooth_weight=1.0, data_weight=0.01, depth_weight=1.0)

    @classmethod
    def depth_then_cam(cls) -> "LossWeights":
        """``train_depth_then_cam.py:44-52`` — DeMoN 192x256 (BASELINE config 3).

        ``sampler="fused"``, where the JAX package keeps ``"xla"``: the one field in which
        a port preset differs from JAX's. Every warp of a config-3 step (16 images, the
        same size in and out) is eligible for the fused kernels, which the JAX package
        ships but no JAX path calls (``pallas_warp.py:48`` keeps its compiled path off).
        """
        return cls(height=192, width=256, max_steps=200_000,
                   smooth_weight=1.0, data_weight=1.0, depth_weight=1.0,
                   explain_reg_weight=0.2, sampler="fused")

    @classmethod
    def optflow_combine(cls) -> "LossWeights":
        """``train_optflow_combine.py:32-41`` — 224x480 (BASELINE config 4).

        ``sampler="pallas"``, as in the JAX package: the step's 12 warps launch the
        port's sampler kernels on the GPU, once each way.
        """
        return cls(height=224, width=480, max_steps=20_000,
                   smooth_weight=0.5, data_weight=0.5, optflow_weight=1.0,
                   depth_weight=50.0, sampler="pallas")

    @classmethod
    def on_demon(cls) -> "LossWeights":
        """``train_depth_only_onDemon.py:42-49`` — DeMoN 192x256 (BASELINE config 5)."""
        return cls(height=192, width=256, max_steps=200_000,
                   smooth_weight=1.0, data_weight=0.01, depth_weight=1.0)

    @classmethod
    def split_training(cls) -> "LossWeights":
        """``split_training.py:58-72`` — pairwise curriculum (600k steps)."""
        return cls(height=192, width=256, max_steps=600_001,
                   smooth_weight=50.0, data_weight=0.0, depth_weight=500.0,
                   depth_sig_weight=1000.0, explain_reg_weight=1.0,
                   cam_weight_rot=160.0, cam_weight_tran=10.0,
                   depth_weight_consist=10.0)

    @classmethod
    def depth_then_cam_lr(cls) -> "LossWeights":
        """``train_depth_then_cam_lr.py:42-50`` — full symmetric L/R training.

        ``sampler="pallas"``, where the JAX package keeps ``"xla"``: a step's 16 samplings
        (8 image warps, 8 inverse-depth resamples, 192x256 down to 24x32) launch the
        port's sampler kernels once each way on the GPU.
        """
        return cls(height=192, width=256, max_steps=200_000,
                   smooth_weight=1.0, data_weight=10.0, depth_weight=20.0,
                   explain_reg_weight=1.0, cam_weight=5.0, cam_consist_weight=5.0,
                   sampler="pallas")

    @classmethod
    def gtdepth_gtcam(cls) -> "LossWeights":
        """``train_depth_then_cam_lr_gtdepth_gtcam.py:44-59``.

        ``sampler="pallas"`` where the JAX package keeps ``"xla"``, as
        ``depth_then_cam_lr()``.
        """
        return cls(height=192, width=256, max_steps=200_000,
                   smooth_weight=5.0, data_weight=1000.0, depth_weight=500.0,
                   sig_depth_weight=1500.0, explain_reg_weight=30.0,
                   cam_consist_weight=10.0, consist_weight=10.0,
                   cam_weight_rot=100.0, cam_weight_tran=10.0, sampler="pallas")

    @classmethod
    def dim11(cls) -> "LossWeights":
        """``train_depth_only_dim11.py:33-41`` — 224x224 joint depth+pose.

        ``sampler="pallas"``, where the JAX package keeps ``"xla"``: a step's 4 Euler warps
        (B=10, so not the ``"fused"`` route's B % 8 == 0) launch the port's sampler
        kernels once each way. A colon-pair preset takes ``"pallas"`` where the median of
        ``chip_smoke.py``'s paired step differences (kernel minus plain sampler, phase 39)
        over its runs is <= 0.
        """
        return cls(height=224, width=224, max_steps=200_000,
                   smooth_weight=1.0, data_weight=0.1, depth_weight=1.0,
                   explain_reg_weight=0.2, sampler="pallas")

    @classmethod
    def only_image(cls) -> "LossWeights":
        """``train_onlyimage.py:32-40`` — 224x480 GT-warp photometric.

        ``sampler="pallas"``, where the JAX package keeps ``"xla"``: a step's 4 warps
        launch the port's sampler kernels once each way (the rule of ``dim11()``).
        """
        return cls(height=224, width=480, max_steps=20_000,
                   smooth_weight=1.0, data_weight=0.1, depth_weight=1.0,
                   sampler="pallas")

    @classmethod
    def optflow_only(cls) -> "LossWeights":
        """``train_optflow_only.py:33-37`` — 224x224 flow-only training."""
        return cls(height=224, width=224, max_steps=20_000,
                   smooth_weight=0.2, data_weight=1.0, optflow_weight=1.0,
                   depth_weight=500.0, sampler="pallas")

    @classmethod
    def sfm_multi(cls) -> "LossWeights":
        """``train.py:32-35`` — SfMLearner-style multi-source, 224x224, batch 30.

        ``sampler="xla"``, as in the JAX package: a step's 4 warps feed only the record,
        forward only, and under the rule of ``dim11()`` the step with the sampler kernel
        was not faster on the card.
        """
        return cls(height=224, width=224, max_steps=20_000,
                   smooth_weight=0.5, data_weight=100.0)

    @classmethod
    def optflow3(cls) -> "LossWeights":
        """``train_optflow.py:32-38`` — 3-channel-head depth training, 224x224."""
        return cls(height=224, width=224, max_steps=20_000,
                   smooth_weight=0.1, data_weight=0.0, depth_weight=10.0)

    def scale_hw(self, s: int) -> tuple[int, int]:
        return int(self.height / 2**s), int(self.width / 2**s)
