"""Parameter-basis transformations.

Port of :mod:`eryn_tpu.utils.transform`: the same
:class:`TransformContainer` on NumPy arrays (host) and on tensors (inside a
likelihood, on any device).  On tensors every step is a column view, a
stack or a fill, with no index tensor: a captured step can hold it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["TransformContainer"]


class TransformContainer:
    """Sampled basis to likelihood basis.

    Args:
        input_basis: names (or ints) of the sampled parameters.
        output_basis: names of the likelihood's parameters.
        parameter_transforms: ``{key or tuple of keys: fn}`` applied in the
            output basis: the single-parameter transforms first, then the
            multi-parameter ones (``fn`` of several columns returns as
            many).
        fill_dict: ``{output name: fixed value}`` for parameters not
            sampled.
        key_map: renames from input to output names.
    """

    def __init__(self, input_basis=None, output_basis=None,
                 parameter_transforms=None, fill_dict=None, key_map={}):
        self.original_parameter_transforms = parameter_transforms
        self.ndim_full = len(output_basis)
        self.ndim = len(input_basis)
        self.input_basis, self.output_basis = input_basis, output_basis

        test_inds = []
        for key in input_basis:
            if key not in output_basis and key not in key_map:
                raise ValueError(
                    "All keys in input_basis must be present in output basis, "
                    "or you must provide a key_map"
                )
            test_inds.append(output_basis.index(key_map.get(key, key)))
        self.test_inds = np.asarray(test_inds)

        def resolve(key):
            if key not in output_basis:
                if key not in key_map:
                    raise ValueError(
                        f"Transform key {key!r} is in neither output_basis "
                        "nor key_map.")
                key = key_map[key]
            return output_basis.index(key)

        self.base_transforms = None
        if parameter_transforms is not None:
            self.base_transforms = {"single_param": {}, "mult_param": {}}
            for key, fn in parameter_transforms.items():
                if isinstance(key, (str, int)) and not isinstance(key, bool):
                    self.base_transforms["single_param"][resolve(key)] = fn
                elif isinstance(key, tuple):
                    self.base_transforms["mult_param"][
                        tuple(resolve(k) for k in key)] = fn
                else:
                    raise ValueError(
                        "Parameter transform keys must be str (or int) or "
                        f"tuple of strs (or ints). {key} is neither."
                    )

        self.original_fill_dict = fill_dict
        self.fill_dict = None
        if fill_dict is not None:
            if not isinstance(fill_dict, dict):
                raise ValueError("fill_dict must be a dictionary.")
            self.fill_dict = {
                "fill_inds": np.asarray(
                    [output_basis.index(k) for k in fill_dict]),
                "fill_values": np.asarray(list(fill_dict.values())),
                "test_inds": self.test_inds,
            }

    def transform_base_parameters(self, params, copy=True,
                                  return_transpose=False, xp=None):
        """Apply the single-, then the multi-parameter transforms to the
        last axis of ``params``; ``return_transpose`` reverses the axes of
        the result."""
        if self.base_transforms is None:
            return params.T if return_transpose else params
        cols = [params[..., i] for i in range(params.shape[-1])]
        for ind, fn in self.base_transforms["single_param"].items():
            cols[ind] = fn(cols[ind])
        for inds, fn in self.base_transforms["mult_param"].items():
            out = fn(*[cols[i] for i in inds])
            for j, i in enumerate(inds):
                cols[i] = out[j]
        if isinstance(params, torch.Tensor):
            result = torch.stack(cols, dim=-1)
            return result.permute(*reversed(range(result.ndim))) if (
                return_transpose) else result
        result = np.stack(cols, axis=-1)
        return result.T if return_transpose else result

    def fill_values(self, params, xp=None):
        """The sampled ``params`` placed in the full basis, the fixed values
        filled in."""
        if self.fill_dict is None:
            return params
        if isinstance(params, torch.Tensor):
            cols = [None] * self.ndim_full
            for j, i in enumerate(self.fill_dict["test_inds"]):
                cols[i] = params[..., j]
            for i, v in zip(self.fill_dict["fill_inds"],
                            self.fill_dict["fill_values"]):
                cols[i] = torch.full_like(params[..., 0], float(v))
            return torch.stack(cols, dim=-1)
        out = np.zeros(params.shape[:-1] + (self.ndim_full,),
                       dtype=params.dtype)
        out[..., self.fill_dict["test_inds"]] = params
        out[..., self.fill_dict["fill_inds"]] = self.fill_dict["fill_values"]
        return out

    def both_transforms(self, params, copy=True, return_transpose=False,
                        xp=None):
        """:meth:`fill_values`, then :meth:`transform_base_parameters`."""
        return self.transform_base_parameters(
            self.fill_values(params), copy=copy,
            return_transpose=return_transpose)

    def __call__(self, params, **kwargs):
        return self.both_transforms(params, **kwargs)
