"""Probe scripts of the port on an NVIDIA H100, named after the TPU probes
in ``scripts/`` that they port: ``exp_boundary_cost`` (P4, the cost of one
kernel boundary) and ``profile_halves`` (P5, K3 and K4 timed apart). Each
runs as ``python -m jcf_tpu_torch.scripts.<name>`` on the card, and with
``--device cpu`` at a small size on the CPU (the plain versions, host-clock
times that say nothing of the card)."""
