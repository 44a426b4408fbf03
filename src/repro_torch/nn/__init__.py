from repro_torch.nn.core import (ParamDict, Spec, count_params, init_params,
                                 params_from_jax, resolve_device)

__all__ = ["ParamDict", "Spec", "count_params", "init_params",
           "params_from_jax", "resolve_device"]
