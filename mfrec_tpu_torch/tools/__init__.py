'''
Measurement tools of the port, run on the card:

    python -m mfrec_tpu_torch.tools.ab_kernel           # P1 vs K1 epochs
    python -m mfrec_tpu_torch.tools.kernel_probe [mode] # K1 deletion probe

Ports of the JAX package's ``tools/ab_kernel.py`` and
``tools/kernel_probe.py``; ``bench_data`` holds their copy of the JAX
bench's data generator and bias-only floor.
'''
