"""Ananke ABM — the PyTorch / CUDA port of ``ananke_abm_tpu``.

The JAX package ``ananke_abm_tpu`` is the reference; this package mirrors
its module paths so that each module's counterpart is easy to find:

- ``ananke_abm_tpu_torch.device``        — device resolution and the f32
                                            matmul policy (no TF32).
- ``ananke_abm_tpu_torch.data_generator`` — the numpy zone worlds and agent
                                            populations (a copy of the JAX
                                            package's).
- ``ananke_abm_tpu_torch.utils.ckpt``    — pickle-of-numpy checkpoints,
                                            readable by both packages.
- ``ananke_abm_tpu_torch.ode``           — ``odeint``: fixed-step RK4 and
                                            Euler, adaptive DOPRI5, the
                                            continuous adjoint.
- ``ananke_abm_tpu_torch.models.gnn_embed`` — the GAT-ODE: zone encoder,
                                            model, flax parameter bridge,
                                            decoded rollout, ``serve``, the
                                            fixed-step trainers and the
                                            continuous-adjoint trainer.
- ``ananke_abm_tpu_torch.ops.cuda``      — hand-written Hopper kernels
                                            (``csrc/``) with their plain
                                            PyTorch versions beside them.

The package imports ``torch`` and never ``jax``, ``flax``, ``optax`` or
anything of ``ananke_abm_tpu``. Its entry points run on the CUDA card
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
