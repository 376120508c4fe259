"""A/B: the sequential VAE-then-policy minibatch step (the reference's
order, ppo.py:197-254 then :265) against the fused joint step
(AlgorithmCfg.fused_joint_step, the default: one shared encoder forward,
both gradients at the params before the VAE step), same seed, short
lite3_dtc training runs.

Evidence behind PARITY.md's "Known deviations": the learning curves
should be the same within run-to-run noise while the fused run spends
less time in the update.  Prints a small table and each variant's wall
time.

    python -m deep_tracking_control_tpu_torch.scripts.ab_fused_step \
        [--iters 300] [--num_envs 4096] [--device cuda]
"""
from . import ab_common as ab

VARIANTS = (False, True)


def variant_cfgs(fused, num_envs, seed=1):
    return ab.variant_cfgs(num_envs, seed, fused_joint_step=fused)


def run_variant(fused, iters, num_envs, seed=1, device="cuda"):
    return ab.run_variant(*variant_cfgs(fused, num_envs, seed), iters,
                          device)


def main(argv=None):
    args = ab.parse_args(argv)
    results = {}
    for fused in VARIANTS:
        print(f"=== fused_joint_step={fused} ===", flush=True)
        results[fused] = run_variant(fused, args.iters, args.num_envs,
                                     device=args.device)
    ab.report(results[False], results[True], "seq", "fused", "fused")


if __name__ == "__main__":
    main()
