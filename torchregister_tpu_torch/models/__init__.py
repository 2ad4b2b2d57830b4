"""Flow-field models: the Attention U-Net."""
