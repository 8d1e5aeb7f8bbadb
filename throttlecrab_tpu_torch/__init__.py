"""throttlecrab-tpu-torch: GCRA rate limiting on PyTorch and CUDA.

The PyTorch/H100 port of `throttlecrab_tpu`, laid out module for module
like it (`tpu/table.py` here is the counterpart of `tpu/table.py` there):

- **core**: the error taxonomy, exact i64 helpers and the result type of
  the scalar GCRA contract.
- **tpu**: the device backend — a bucket table of packed int32 rows on
  the card, the composed torch decide (`tpu/kernel.py`, the plain
  version) and the hand-written CUDA decision-window kernel
  (`tpu/fused.py` over `csrc/fused_window.cu`).
- **server**: the micro-batching engine and the HTTP/JSON transport.

Every entry point runs on `cuda` unless the caller asks for the CPU.
Time is always an explicit input in integer nanoseconds since the epoch.
"""
