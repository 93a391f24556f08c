"""Profiling hooks (``profiling.py``) and logging with stage timers
(``logging.py``), as the JAX package's ``utils/`` has them."""
