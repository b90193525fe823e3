"""The reference tasks, one module each, found by the configuration's
`task` (`reference.envs.make`): `make(model, extra)` builds the env from
the loaded model and the model file's other arrays, as the program's
registry does for the same env id, with random targets."""
