"""The device an entry point runs on: the card unless the caller names
another (the tests pass device="cpu"); never a silent fall-back."""

import torch


def resolve_device(device=None, what: str = "training") -> torch.device:
    """`device`, or the card where it is None; raises where there is none.
    `what` names the work in the error ("training", "RAFT", ...)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device: {what} runs on the card; pass device='cpu' "
                               "(--device cpu) to run it on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
