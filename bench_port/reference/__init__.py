"""The plain reference that decides `correct` (bench_port/harness/check.py).

`dtc` is a frozen copy of the port's plain paths: the environment (the
physics decimation step, terrain sampler, foothold planner, rewards and
observations as the port runs them on a CPU tensor, with the noise drawn
by the plain Philox), the terrain generator (its C++ source, built with
g++ into dtc/_build), the ActorCriticDecoder and PPO with its optimizers.
The kernel launches are taken out: every wrapper runs its plain version
on any device.  It imports torch and numpy only, and nothing of jax, of
the JAX package or of the port.

Three switches serve the check's readings and nothing else:
`dtc.models.networks.LOWER` (the control: every bf16 product of the
networks with its operands rounded to float8), `dtc.models.networks.
WITNESS` (a sound rewrite: every bf16 product with its inner width padded
to a multiple of 8 and the bias added in its epilogue) and
`dtc.agent.ppo.HALF_BATCH` (a fault: each minibatch's second half left
out).
"""
