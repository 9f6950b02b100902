"""GPT, VQ-VAE and MelGAN for inference."""
