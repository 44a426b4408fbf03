from repro_torch.nn.core import (ParamDict, Spec, count_params, init_params,
                                 init_tree, params_from_jax, resolve_device,
                                 stack_specs, tree_at, tree_leaves, tree_map,
                                 tree_unflatten)

__all__ = ["ParamDict", "Spec", "count_params", "init_params", "init_tree",
           "params_from_jax", "resolve_device", "stack_specs", "tree_at",
           "tree_leaves", "tree_map", "tree_unflatten"]
