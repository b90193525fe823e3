"""User tools: inverse kinematics, trajectories, curriculum, quaternion and
vector math, and the `examine_env` CLI."""
