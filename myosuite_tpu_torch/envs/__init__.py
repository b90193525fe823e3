"""Environments of the PyTorch port."""

from myosuite_tpu_torch.envs.base import MyoEnv, State
from myosuite_tpu_torch.envs.registry import make, registered_envs
