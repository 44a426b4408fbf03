from repro_torch.nn.core import (ParamDict, Spec, axes_tree, count_params,
                                 init_params, init_tree, params_from_jax,
                                 resolve_device, shapes_tree, stack_specs,
                                 tree_at, tree_leaves, tree_map,
                                 tree_unflatten)
from repro_torch.nn.sharding import (DEFAULT_RULES, constrain, constrain_tree,
                                     current_mesh, named_sharding,
                                     resolve_spec, tree_shardings, use_mesh)

__all__ = ["DEFAULT_RULES", "ParamDict", "Spec", "axes_tree", "constrain",
           "constrain_tree", "count_params", "current_mesh", "init_params",
           "init_tree", "named_sharding", "params_from_jax",
           "resolve_device", "resolve_spec", "shapes_tree", "stack_specs",
           "tree_at", "tree_leaves", "tree_map", "tree_shardings",
           "tree_unflatten", "use_mesh"]
