"""FreSh on PyTorch and CUDA: the port of `repro` to an NVIDIA H100.

`repro_torch.api.FreshIndex` builds the flat iSAX index and answers exact
k-NN queries.  Its three kernels (summarize, lb_distance, refine_topk)
are CUDA C++ under `kernels/csrc/`, built with nvcc at first use; each
wrapper runs its plain PyTorch version when given CPU tensors.
"""
