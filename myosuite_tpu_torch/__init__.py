"""myosuite_tpu_torch: the PyTorch and CUDA port of myosuite_tpu.

Batched musculoskeletal physics and environments in PyTorch, with the
constraint solve in a hand-written CUDA kernel for NVIDIA Hopper. Entry
points run on CUDA unless the caller names another device:

  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0")
  state = env.reset(torch.Generator("cuda").manual_seed(0), batch=4096)
  state = env.step(state, actions)      # actions: (batch, env.action_size)
"""

__version__ = "0.1.0"

import torch as _torch

# float32 everywhere, never TF32 (the JAX package's products run at HIGHEST
# precision): matmuls and cuDNN convolutions alike
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from myosuite_tpu_torch.envs import make, registered_envs


def __getattr__(name):
  """The suite id lists of the JAX package (myosuite_myobase_suite,
  myosuite_myochal_suite, myosuite_myodm_suite, myosuite_myoedit_suite),
  from the registry's suite tags."""
  tags = {"myosuite_myobase_suite": "myobase",
          "myosuite_myochal_suite": "myochal",
          "myosuite_myodm_suite": "myodm",
          "myosuite_myoedit_suite": "myoedits"}
  if name in tags:
    from myosuite_tpu_torch.envs import registry
    return sorted(i for i in registered_envs()
                  if registry.suite_of(i) == tags[name])
  raise AttributeError(name)
