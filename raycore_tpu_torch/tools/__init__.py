"""Card probes: the counterparts of the repository's measurement tools in
``tools/``, each a hand-written CUDA kernel with one compile-time variant
per variant of the TPU tool, a plain PyTorch version beside it, and a
``main()`` that runs the tool's own list of configurations on the card.

  gather_probe          <- tools/tpu_gather_probe.py (P1): per-lane row
                           fetch from a resident table (loop, onehot, take)
  epilogue_experiments  <- tools/epilogue_experiments.py (P2): per-block
                           cost of the worklist sweep's epilogue variants
  probe_matmul_shapes   <- tools/probe_matmul_shapes.py (P3): small-depth
                           contraction cost by shape and precision
  probe_block_overhead  <- tools/probe_block_overhead.py (P4): ablations of
                           the regroup sweep's per-block cost

Run one as ``python -m raycore_tpu_torch.tools.<name> [args]``; it takes
the tool's arguments and prints the tool's rows, with times from CUDA
events. Without a card it raises.
"""
