"""Command-line tools of the port, each the counterpart of the JAX
package's script of the same name under `scripts/`, on the card unless
asked for the CPU:

- `profile_launch`: the per-launch cost split (ping, h2d, compute, d2h,
  end to end, pipelined), and its transfer probes `probe_async` (do
  copies and launches queue?), `probe_d2h` (every fetch strategy) and
  `probe_duplex` (do uploads and fetches overlap?), over the helpers of
  `card`;
- `probe_sharded_1dev`: the cross-batch state carry on a 1-device mesh;
- the CI gates `replay_determinism` and `control_determinism`;
- `run-transport-test.sh`: the server and the load harness per transport;
- `fuzz_wire_tiers`: the tier-ladder differential campaign;
- `byid_cpu_replay`: the by-id route's decisions/s on the CPU, in a
  fresh process.
"""
