"""Command-line tools of the port: the tier-ladder differential campaign
(`fuzz_wire_tiers`) and the by-id CPU replay timer (`byid_cpu_replay`)."""
