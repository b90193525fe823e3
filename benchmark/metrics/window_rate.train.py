"""Every env-step of the training steps completed in the traced run's
window over the window's wall time, as `train_env_steps_per_s` is taken,
with the rollout's and the update's spans open."""


def read(ctx):
  w = ctx.window
  return w.env_steps / w.window_s if w is not None and w.window_s else None
