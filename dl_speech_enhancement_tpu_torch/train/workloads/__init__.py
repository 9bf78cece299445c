"""The AudioDec framework's workloads on the GAN driver (train/gan_trainer.py)."""
