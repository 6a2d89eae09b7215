"""Runtime around the step (port of ``easyparallellibrary_tpu/runtime``):
mixed precision (``amp``) and the step watchdog (``resilience``)."""
