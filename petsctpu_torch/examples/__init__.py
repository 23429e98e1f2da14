"""The example CLIs (petsctpu's examples/*.py) on the port.

One module for each reference CLI, each with `main(argv, device=None)`
and runnable as `python -m petsctpu_torch.examples.<name> [options]`.
Each prints the lines the reference CLI prints. `device` None means the
card (CUDA): without CUDA, main raises (petsctpu_torch/device.py);
tests pass device="cpu". `main` returns what the run produced (a solve
result, or ex10's Ex10Run).
"""
