"""PyTorch / CUDA port of the neural-Jacobian-field system for one NVIDIA
H100, beside the JAX reference package `neural_jacobian_field_tpu`.

Serving: encode a context image, render views (inference/render.py) and
solve inverse dynamics (inference/action_opt.py); training in two stages
(training/), run from the command line as `python -m
neural_jacobian_field_torch.train` over the repo's configurations/ with
the host data pipeline (data/); the inference toolbox (load_model,
joint-sensitivity maps, reference checkpoints: inference/, utils/
port_torch.py), RAFT optical flow (flow/) and weight ingestion (`python -m
neural_jacobian_field_torch.ingest`); hand-written Hopper kernels under
ops/kernels/ (sources in csrc/). This package imports torch, never jax,
flax or the JAX package.
"""
