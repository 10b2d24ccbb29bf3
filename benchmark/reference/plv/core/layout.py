"""Fixed error-state layout for the sliding-window filter (L2).

The port's own copy of plviwo_tpu/core/layout.py (pure Python): the port
imports nothing of the JAX package.  tests/test_torch_fused_frame.py holds
the two copies to the same dimensions and block offsets.

The reference (`PL-VIWO/src/state/State.h:163-229`) grows/shrinks a dense
covariance as clones and calibration states come and go.  On TPU everything
under jit must have static shapes, so the layout is *fixed at configuration
time*: the covariance is a (D, D) matrix whose block structure never changes,
clones live in a ring buffer of `n_clones` slots with a validity mask, and
marginalization is a mask/zero operation instead of a resize
(SURVEY.md section 7 "Hard parts").

Error-state ordering (matches the reference's IMU ordering, `types/IMU.h`):

    [ imu(15) | clones(6*C) | cam calib | wheel calib | gps calib | wtoe(4) | slam(3*S) ]

    imu   = [theta(3) p(3) v(3) bg(3) ba(3)]
    clone = [theta(3) p(3)] per slot
    cam   = per camera: dt(1) + ext[theta(3) p(3)] + intr(8)
    wheel = dt(1) + ext[theta(3) p(3)] + intr(3)        (if enabled)
    gps   = per gps: dt(1) + ext p(3)                   (if enabled)
    wtoe  = [theta_z(1) p(3)]  4-DoF world->ENU (transient, GPS init)
    slam  = [xyz(3)] per landmark slot
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StateLayout:
    n_clones: int = 22
    n_cams: int = 1
    max_slam: int = 0
    use_wheel: bool = False
    n_gps: int = 0

    # --- imu block ---
    IMU_TH = 0
    IMU_P = 3
    IMU_V = 6
    IMU_BG = 9
    IMU_BA = 12
    IMU_DIM = 15

    @property
    def clone_off(self) -> int:
        return self.IMU_DIM

    def clone(self, i: int) -> int:
        """Start index of clone slot i (theta at +0, p at +3)."""
        return self.clone_off + 6 * i

    @property
    def cam_off(self) -> int:
        return self.clone_off + 6 * self.n_clones

    CAM_CALIB_DIM = 1 + 6 + 8  # dt + ext + intrinsics

    def cam_dt(self, i: int) -> int:
        return self.cam_off + self.CAM_CALIB_DIM * i

    def cam_ext(self, i: int) -> int:
        return self.cam_dt(i) + 1

    def cam_int(self, i: int) -> int:
        return self.cam_ext(i) + 6

    @property
    def wheel_off(self) -> int:
        return self.cam_off + self.CAM_CALIB_DIM * self.n_cams

    WHEEL_CALIB_DIM = 1 + 6 + 3

    @property
    def wheel_dt(self) -> int:
        return self.wheel_off

    @property
    def wheel_ext(self) -> int:
        return self.wheel_off + 1

    @property
    def wheel_int(self) -> int:
        return self.wheel_off + 7

    @property
    def gps_off(self) -> int:
        return self.wheel_off + (self.WHEEL_CALIB_DIM if self.use_wheel else 0)

    GPS_CALIB_DIM = 1 + 3

    def gps_dt(self, i: int) -> int:
        return self.gps_off + self.GPS_CALIB_DIM * i

    def gps_ext(self, i: int) -> int:
        return self.gps_dt(i) + 1

    @property
    def wtoe_off(self) -> int:
        return self.gps_off + self.GPS_CALIB_DIM * self.n_gps

    WTOE_DIM = 4  # only allocated when gps enabled

    @property
    def slam_off(self) -> int:
        return self.wtoe_off + (self.WTOE_DIM if self.n_gps > 0 else 0)

    def slam(self, i: int) -> int:
        return self.slam_off + 3 * i

    @property
    def dim(self) -> int:
        return self.slam_off + 3 * self.max_slam
