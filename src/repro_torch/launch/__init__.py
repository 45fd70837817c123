"""Launch-side code (counterpart of ``repro.launch``): the one-card FL train
step and serve steps, and their entry points (``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.serve``)."""
