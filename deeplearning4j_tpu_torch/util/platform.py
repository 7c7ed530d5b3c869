"""Which device a command runs on (counterpart of
``deeplearning4j_tpu/util/platform.py``).

The JAX package's ``pin_cpu_platform`` exists because a hardware plugin
re-pins jax's platform at import, over ``JAX_PLATFORMS``: it enforces an
explicit ``JAX_PLATFORMS=cpu`` through ``jax.config`` before any backend
use. torch has no platform plugin and no process-wide platform to pin,
so this module holds no code: each of the port's entry points takes a
device. The JAX package's CPU request (``JAX_PLATFORMS=cpu``) maps to
the port's ``--device cpu``, and its default (the TPU the plugin picks)
to the port's default ``cuda``. A verb resolves its ``--device`` with
``device.resolve_device``: an explicit CPU request always runs on the
CPU, and the default raises without a card rather than running
somewhere slower.
"""
