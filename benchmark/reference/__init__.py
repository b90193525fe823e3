"""The plain reference that decides `correct`.

A frozen copy of the program's plain PyTorch path (physics, the two tasks,
the auto-reset and the PPO learner), with its imports rewritten to this
package and its Newton kernels replaced by their plain version on every
device. It imports nothing of the program and reads the benchmark's own
frozen copy of each configuration's model file. Frozen: a change to the
program does not change it, so the two are held against each other.
"""
