"""flvis_tpu — a stereo visual-inertial SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of FLVIS
(HKPolyU-UAV/FLVIS, C++/ROS reference at /root/reference): feature-tracking
visual odometry frontend, IMU feedforward/feedback fusion, sliding-window
bundle adjustment, and bag-of-words loop closure with pose-graph optimization.

Architecture (not a port):
  - All per-frame state lives in fixed-shape arrays (SoA landmark tables,
    ring buffers) so the whole frontend step is one jitted XLA program.
  - RANSAC / branchy logic is re-cast as masked batched hypothesis scoring.
  - g2o is replaced by a JAX Levenberg-Marquardt engine with analytic
    Jacobians and a Schur complement over landmark blocks.
  - The ROS nodelet pipeline is replaced by a single-controller async
    dispatch pipeline; multi-device scaling via jax.sharding meshes.
"""

__version__ = "0.1.0"
