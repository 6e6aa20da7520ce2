"""Training: losses, steps, optimizer schedule, checkpoints and the loop
(``python -m stroke_derenderer_tpu_torch.train.loop``)."""
