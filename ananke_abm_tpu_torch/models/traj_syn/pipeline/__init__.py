"""traj_syn pipelines: train_full / validate / vae_only."""
