"""PyTorch/CUDA port of the social-MPC trajectory optimisation framework.

The package mirrors ``nav2_social_mpc_controller_tpu`` (the JAX reference):
same sub-packages, same function names, PyTorch inside. It imports torch and
NumPy only, and nothing of the JAX package. The kernels the reference wrote
for the TPU are CUDA C++ kernels for Hopper here (``csrc/``), built at first
use by ``_build.py``.

Entry points:
  controller.controller.make_step_batch(cfg)   one batched control tick (and
      make_step_batch_compacted), with core.types.scenario_from_numpy /
      controller.controller.make_carry to put a scenario batch on the device
  controller.controller.make_step(cfg)         one robot's tick (a batch of one)
  controller.controller.SocialMPCController    the nav2_core::Controller-shaped
      lifecycle object around make_step
  runtime.simulator.simulate / make_simulate   closed-loop campaigns, B loops
      in lockstep
  runtime.stream.ControllerLoop                the fixed-rate (20 Hz) loop
  runtime.scenario_native.generate_scenario_batch  native (g++) scenario
      batches; runtime.esdf.build_esdf the native ESDF
  world.transforms                             SE(2) frames and grid rebases
  parallel.mesh.make_distributed_step          the batched step over
      torch.distributed ranks (parallel.multihost.initialize first)
  runtime.campaign.run_campaign                multi-process campaigns with
      checkpoint/resume (utils.checkpoint)
  python -m nav2_social_mpc_controller_tpu_torch  the CLI: step, sim, bench,
      dryrun, config, multihost
Every entry point runs on the card unless the caller passes ``device="cpu"``
(the CLI: ``--platform cpu``); asking for the card where there is none
raises.
"""

__version__ = "0.1.0"
