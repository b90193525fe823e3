from myosuite_tpu_torch.renderer.renderer import (PassiveViewer, Renderer,
                                                  render_qpos_sequence,
                                                  render_rollout)
