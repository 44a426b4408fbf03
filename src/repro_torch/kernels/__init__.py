"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that launches the kernel
for CUDA tensors and runs the plain version for CPU tensors."""


def launch_counts() -> dict:
    """{kernel: launches so far in this process}, read from each
    kernel's wrapper (which counts where it launches its kernel); the
    names are PERF.md's kernel-table rows."""
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.prefill_attention import ops as pre
    from repro_torch.kernels.quant_channel import ops as qc
    fns = {"packed_wire_2d": qc.packed_wire_2d,
           "packed_wire_mean_2d": qc.packed_wire_mean_2d,
           "quant_channel_2d": qc.quant_channel_2d,
           "packed_wire_2d_philox": qc.packed_wire_2d_philox,
           "conv_pool": cp.user_conv_pool,
           "lstm_final_state": lc.lstm_final_state,
           "decode_attention": dec.gqa_decode,
           "paged_decode_attention": dec.gqa_decode_paged,
           "prefill_attention": pre.gqa_prefill,
           "paged_prefill_attention": pre.gqa_prefill_paged}
    return {k: f.launches for k, f in fns.items()}
