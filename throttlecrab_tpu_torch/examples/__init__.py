"""The port's examples: the JAX package's `examples/` over
`TorchRateLimiter`, `ShardedTorchRateLimiter` and the port's `core/`,
`tpu/cleanup.py` and `server/proto`, one module each, each runnable as

    python -m throttlecrab_tpu_torch.examples.<name> [--cpu]

`basic` (the embedded scalar library), `batch_tpu` (thousands of
decisions per launch), `byid_launch` (raw ids against device-resident
parameter rows), `access_patterns`, `capacity_test`, `store_comparison`,
`performance_demo`, `sharded_mesh`, and the clients of a running server
`http_client` and `grpc_client`.  Every example that touches the device
runs on the card unless `--cpu` asks for the plain version; none does
any work when imported.
"""
