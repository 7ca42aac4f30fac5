"""The policy gym's seams, as far as the port has them: the estimator's
client of a shared fleet coalescer (``env.FleetEstimatorClient``). The
rest of ``autoscaler_tpu/gym/`` (the env over the load generator, the
tuner) is ROADMAP queue 1 item 6."""
