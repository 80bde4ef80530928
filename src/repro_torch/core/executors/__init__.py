"""Discrete-event executor backend models (sim mode). Importing a module
registers its backend with ``repro_torch.runtime.registry``; real-mode backends
live in ``repro_torch.runtime.real_executors``."""
