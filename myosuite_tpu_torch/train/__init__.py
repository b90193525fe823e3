"""PPO training of the PyTorch port (networks, running stats, PPO,
checkpoints, callbacks and the `train_ppo` CLI)."""
