"""Typed option tree (port of plviwo_tpu/config/options.py).

The port's own copy of the JAX package's dataclass tree (pure Python; the
port imports nothing of the JAX package): the same classes, fields and
defaults, which tests/test_torch_system.py holds equal field by field.
They mirror the reference's option structs (`PL-VIWO/src/options/*`).
`config/yaml_io.py` loads the tree from layered YAML.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field


@dataclasses.dataclass
class ImuOptions:
    """Mirrors OptionsIMU: noise densities + random walks (continuous-time)."""
    enabled: bool = True
    sigma_w: float = 1.7e-4   # gyro white noise  [rad/s/sqrt(Hz)]
    sigma_wb: float = 1.9e-5  # gyro bias walk
    sigma_a: float = 2.0e-3   # accel white noise [m/s^2/sqrt(Hz)]
    sigma_ab: float = 3.0e-3  # accel bias walk
    # initial std for the state prior
    init_cov_dbg: float = 1e-2
    init_cov_dba: float = 1e-2
    init_cov_ori: float = 1e-3
    init_cov_pos: float = 1e-6
    init_cov_vel: float = 1e-2


@dataclasses.dataclass
class CameraOptions:
    """Mirrors OptionsCamera (OptionsCamera.h:31-120), pruned to used fields."""
    enabled: bool = True
    max_n: int = 1
    # tracking
    n_pts: int = 250
    fast_threshold: int = 20
    grid_x: int = 10
    grid_y: int = 8
    min_px_dist: int = 10
    histogram: bool = True
    downsample: bool = False
    # selection / update
    max_slam: int = 0
    max_msckf: int = 40
    min_track_length: int = 3
    feat_rep: str = "GLOBAL_3D"
    sigma_pix: float = 1.0
    chi2_mult: float = 1.0
    # lines
    use_lines: bool = False
    max_lines: int = 40
    sigma_pix_line: float = 1.5
    # fused image engine: dtype of the heavy per-feature camera tensors
    # (triangulation/Jacobians/gate): "f32" (the gate/Gram kernel's) or "f64"
    fused_dtype: str = "f32"
    # fused image engine: observation-history depth per track slot.  A
    # track harvests when it dies or fills O obs; larger O = longer
    # triangulation baselines per harvest (the DB path uses the full clone
    # window) at linearly more row-build work.  12 ~ the 1 s / 10 Hz clone
    # window
    fused_max_obs: int = 12
    # fused image engine: gather-free shifted-MAC LK (True; the port's only
    # LK, its VioSystem refuses False) vs the gather formulation
    fused_lk_conv: bool = True
    # point-line-coupled rows (reference ships use_PLC=false,
    # UpdaterCamera.cpp PLC flag; LineHelper.cpp:879-890)
    use_plc: bool = False
    max_plc: int = 4  # attached-point rows per line observation
    # calibration flags
    do_calib_dt: bool = False
    do_calib_ext: bool = False
    do_calib_int: bool = False
    init_cov_dt: float = 1e-3
    init_cov_ext_or: float = 1e-3
    init_cov_ext_pos: float = 1e-2
    init_cov_in_k: float = 1.0
    init_cov_in_c: float = 1.0
    init_cov_in_r: float = 1e-4
    # per-camera parameters (lists of length max_n)
    timeoffsets: list = field(default_factory=lambda: [0.0])
    intrinsics: list = field(default_factory=list)   # each: 8-list
    distortion_models: list = field(default_factory=lambda: ["radtan"])
    extrinsics: list = field(default_factory=list)   # each: [qx qy qz qw, px py pz] (q_ItoC, p_IinC)
    wh: list = field(default_factory=lambda: [[752, 480]])
    # triangulation
    triangulation_max_cond: float = 10000.0
    triangulation_min_dist: float = 0.1
    triangulation_max_dist: float = 200.0


@dataclasses.dataclass
class WheelOptions:
    """Mirrors OptionsWheel: 6 types 2D/3D x {Ang,Lin,Cen}."""
    enabled: bool = False
    type: str = "Wheel3DAng"
    noise_w: float = 0.1
    noise_v: float = 0.1
    noise_p: float = 0.05
    # intrinsics: [radius_left, radius_right, baseline]
    intrinsics: list = field(default_factory=lambda: [0.5, 0.5, 1.5])
    extrinsics: list = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    timeoffset: float = 0.0
    do_calib_dt: bool = False
    do_calib_ext: bool = False
    do_calib_int: bool = False
    init_cov_dt: float = 1e-3
    init_cov_ext_or: float = 1e-3
    init_cov_ext_pos: float = 1e-2
    init_cov_in_r: float = 1e-4
    init_cov_in_b: float = 1e-4
    chi2_mult: float = 1.0


@dataclasses.dataclass
class GpsOptions:
    enabled: bool = False
    max_n: int = 1
    noise: float = 3.0
    chi2_mult: float = 1.0
    init_distance: float = 20.0
    keyframe_min_distance: float = 1.0
    extrinsics: list = field(default_factory=lambda: [[0.0, 0.0, 0.0]])
    timeoffsets: list = field(default_factory=lambda: [0.0])
    do_calib_dt: bool = False
    do_calib_ext: bool = False
    init_cov_dt: float = 1e-3
    init_cov_ext: float = 1e-2


@dataclasses.dataclass
class ZuptOptions:
    """Mirrors the intended OptionsZupt (missing from the reference snapshot,
    SURVEY.md defect #1)."""
    enabled: bool = False
    sigma_v: float = 0.05
    sigma_w: float = 0.01
    gyro_thresh: float = 0.02
    accel_var_thresh: float = 0.05
    window: float = 0.3
    chi2_mult: float = 5.0


@dataclasses.dataclass
class InitOptions:
    """Mirrors OptionsInit."""
    window_time: float = 1.0
    imu_thresh: float = 1.0      # excitation threshold (I_Initializer)
    imu_only_init: bool = False
    imu_gravity_aligned: bool = True
    use_gt: bool = False
    cov_size: float = 1e-4


@dataclasses.dataclass
class EstimatorOptions:
    """Mirrors OptionsEstimator (OptionsEstimator.h:21-121)."""
    gravity_mag: float = 9.81
    window_size: float = 1.0     # seconds of clones kept
    clone_freq: int = 10         # Hz
    intr_order: int = 3          # polynomial interpolation order
    dynamic_cloning: bool = False
    use_imu_res: bool = False
    use_imu_cov: bool = False
    use_pol_cov: bool = False
    # joint multi-sensor update: build the point/line/wheel rows
    # at the same pre-update state and apply ONE compress + EKF update per
    # frame (the fused_step_full design), instead of the reference's
    # sequential per-sensor updates (UpdaterCamera then lines then wheel,
    # re-linearizing between).  Differences are second order in the
    # per-frame correction; saves two full covariance rewrites per frame.
    joint_update: bool = True
    imu: ImuOptions = field(default_factory=ImuOptions)
    cam: CameraOptions = field(default_factory=CameraOptions)
    wheel: WheelOptions = field(default_factory=WheelOptions)
    gps: GpsOptions = field(default_factory=GpsOptions)
    zupt: ZuptOptions = field(default_factory=ZuptOptions)
    init: InitOptions = field(default_factory=InitOptions)

    @property
    def max_clones(self) -> int:
        """Ring-buffer capacity: window seconds at clone_freq plus margin."""
        return int(self.window_size * max(self.clone_freq, 4)) + 2


@dataclasses.dataclass
class SystemOptions:
    verbosity: int = 2
    save_trajectory: bool = True
    save_state: bool = False
    path_out: str = "outputs"


@dataclasses.dataclass
class Options:
    sys: SystemOptions = field(default_factory=SystemOptions)
    est: EstimatorOptions = field(default_factory=EstimatorOptions)
