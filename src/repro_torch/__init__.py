"""FreSh on PyTorch and CUDA: the port of `repro` to an NVIDIA H100.

`repro_torch.api.FreshIndex` builds the flat iSAX index and answers exact
k-NN queries.  Its three kernels (summarize, lb_distance, refine_topk)
are CUDA C++ under `kernels/csrc/`, built with nvcc at first use; each
wrapper runs its plain PyTorch version when given CPU tensors.

Its packages `core`, `quality` and `checkpoint` answer repro's
package-level names, each resolved at first use (`_exports`).
"""

import importlib


def _exports(package: str, names: dict):
    """A package's module `__getattr__` and `__dir__` for {submodule:
    (name, ...)}: a name imports its submodule when first read (an eager
    import would cycle through the kernels)."""
    home = {name: mod for mod, mod_names in names.items()
            for name in mod_names}

    def __getattr__(name):
        if name not in home:
            raise AttributeError(f"module {package!r} has no attribute "
                                 f"{name!r}")
        module = importlib.import_module(f"{package}.{home[name]}")
        return getattr(module, name)

    def __dir__():
        return sorted(set(vars(importlib.import_module(package))) | set(home))

    return __getattr__, __dir__
