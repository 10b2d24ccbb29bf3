"""L2 filter core: state, EKF primitives, IMU propagation, the fused step."""
