"""examine_sim CLI: load a raw MJCF (or a registered env's model), step the
physics, print a summary and optionally a snapshot.

The JAX package's `utils.examine_sim`: print the model's sizes, step the
port's physics with zero or uniform random controls, report the step's
time and the state's drift, and with --png draw the final state with the
port's ray caster (`renderer.Renderer`). -m compiles the MJCF through
`physics.io.put_model`, which needs MuJoCo on the host: where MuJoCo is
not installed it raises an ImportError that names MuJoCo. -e loads a registered env's model
file and needs no MuJoCo.

Usage:
  python -m myosuite_tpu_torch.utils.examine_sim -m model.xml [-n 100] \\
      [--png out] [--device cpu]
  python -m myosuite_tpu_torch.utils.examine_sim -e MtxElbowPoseRandom-v0
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("-m", "--model_path", default=None,
                      help="MJCF xml path or string")
  parser.add_argument("-e", "--env_name", default=None,
                      help="registered env id (alternative to -m)")
  parser.add_argument("-n", "--num_steps", type=int, default=100)
  parser.add_argument("--ctrl", choices=["zero", "random"], default="zero")
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--png", default=None, help="snapshot png prefix")
  parser.add_argument("--device", default="cuda",
                      help="torch device to run on (default cuda)")
  args = parser.parse_args(argv)

  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import io as physics_io

  if args.env_name:
    import myosuite_tpu_torch
    m = myosuite_tpu_torch.make(args.env_name, device=args.device).model
  else:
    if not args.model_path:
      parser.error("need -m or -e")
    xml = args.model_path
    if os.path.exists(xml):
      with open(xml) as f:
        xml = f.read()
    m = physics_io.put_model(xml, args.device)

  print(f"model: nq={m.nq} nv={m.nv} nu={m.nu} na={m.na} nbody={m.nbody} "
        f"ngeom={m.ngeom} ntendon={m.ntendon} ncon_max={m.ncon_max}")

  d = physics_io.make_data(m, 1)
  if args.ctrl == "random":
    gen = torch.Generator(m.device).manual_seed(args.seed)
    d = d.replace(ctrl=torch.rand(1, m.nu, generator=gen, device=m.device))
  sync = (torch.cuda.synchronize if m.device.type == "cuda"
          else lambda: None)
  with torch.no_grad():
    t0 = time.perf_counter()
    d = forward.step(m, d)
    sync()
    print(f"first step: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    for _ in range(args.num_steps - 1):
      d = forward.step(m, d)
    sync()
  dt_step = (time.perf_counter() - t0) / max(args.num_steps - 1, 1)
  print(f"steady-state: {1e3 * dt_step:.3f} ms/step "
        f"({1.0 / max(dt_step, 1e-9):,.0f} steps/s single env)")
  print(f"t={float(d.time[0]):.3f}s |qpos|={float(d.qpos.norm()):.4f}"
        f" |qvel|={float(d.qvel.norm()):.4f}"
        f" finite={bool(torch.isfinite(d.qpos).all())}")

  if args.png:
    import imageio

    from myosuite_tpu_torch.renderer import Renderer
    path = f"{args.png}.png"
    imageio.imwrite(path, Renderer(m, width=640, height=480).render(d)[0]
                    .cpu().numpy())
    print(f"saved snapshot: {path}")


if __name__ == "__main__":
  main()
