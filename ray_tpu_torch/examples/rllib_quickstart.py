"""Quickstart: train PPO with rollout workers and a learner on the card.

    python -m ray_tpu_torch.examples.rllib_quickstart

Port of ``ray_tpu/examples/rllib_quickstart.py`` (reference analog: the
``Algorithm`` quickstarts in the reference's RLlib docs: config builder
-> .build() -> train loop). JAX's starts its runtime for the rollout
actors; the port's rollout workers run in this process, so there is no
runtime to start. Runs on the card; ``main(device="cpu")`` runs on the
CPU.
"""

from ray_tpu_torch.rllib import PPOConfig


def main(device="cuda") -> list:
    """Train 10 iterations; returns each iteration's result."""
    algo = (PPOConfig(device=device)
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=3e-4, num_sgd_iter=4)
            .build())
    results = []
    try:
        for _ in range(10):
            result = algo.train()
            results.append(result)
            print(f"iter {result['training_iteration']:2d} "
                  f"return={result['episode_return_mean']:.1f} "
                  f"episodes={result['num_episodes']}")
    finally:
        algo.stop()
    return results


if __name__ == "__main__":
    main()
