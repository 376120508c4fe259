"""A/B: minibatch_perm_granule=1 (the reference's per-row shuffle) against
G=16 (the group shuffle, the default), same seed, short lite3_dtc
training runs.

Evidence behind PARITY.md's "Known deviations": the two runs should show
the same learning progress (reward and episode-length curves within
run-to-run noise) while G=16 spends less time in the update.  Prints a
small table and each variant's wall time.

    python -m deep_tracking_control_tpu_torch.scripts.ab_granule \
        [--iters 300] [--num_envs 4096] [--device cuda]
"""
from . import ab_common as ab

VARIANTS = (1, 16)


def variant_cfgs(granule, num_envs, seed=1):
    return ab.variant_cfgs(num_envs, seed, minibatch_perm_granule=granule)


def run_variant(granule, iters, num_envs, seed=1, device="cuda"):
    return ab.run_variant(*variant_cfgs(granule, num_envs, seed), iters,
                          device)


def main(argv=None):
    args = ab.parse_args(argv)
    results = {}
    for g in VARIANTS:
        print(f"=== granule {g} ===", flush=True)
        results[g] = run_variant(g, args.iters, args.num_envs,
                                 device=args.device)
    ab.report(results[1], results[16], "G=1", "G=16", "with G=16")


if __name__ == "__main__":
    main()
