"""Runnable scripts of the port (counterparts of the repo's ``scripts/`` on
the convergence path): ``python -m tae_tpu_torch.scripts.<name>``."""
