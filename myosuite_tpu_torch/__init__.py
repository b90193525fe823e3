"""myosuite_tpu_torch: the PyTorch and CUDA port of myosuite_tpu.

Batched musculoskeletal physics and environments in PyTorch, with the
constraint solve in a hand-written CUDA kernel for NVIDIA Hopper. Entry
points run on CUDA unless the caller names another device:

  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0")
  state = env.reset(torch.Generator("cuda").manual_seed(0), batch=4096)
  state = env.step(state, actions)      # actions: (batch, env.action_size)
"""

__version__ = "0.1.0"

from myosuite_tpu_torch.envs import make, registered_envs
