"""Launch-side code (counterpart of ``repro.launch``): the one-card serve
steps and the serve entry point (``python -m repro_torch.launch.serve``)."""
