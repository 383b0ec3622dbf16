"""PyTorch/CUDA port of the social-MPC trajectory optimisation framework.

The package mirrors ``nav2_social_mpc_controller_tpu`` (the JAX reference):
same sub-packages, same function names, PyTorch inside. It imports torch and
NumPy only, and nothing of the JAX package. The kernels the reference wrote
for the TPU are CUDA C++ kernels for Hopper here (``csrc/``), built at first
use by ``_build.py``.

Entry point: ``controller.controller.make_step_batch(cfg)`` — one batched
control tick — with ``core.types.scenario_from_numpy`` /
``controller.controller.make_carry`` to put a scenario batch on the device.
Every entry point runs on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
