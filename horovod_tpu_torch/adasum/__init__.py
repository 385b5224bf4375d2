"""Adasum: scale-adaptive gradient summation (Maleki et al., 2020).

:mod:`.vhdd` holds the exchange over ``torch.distributed``;
:mod:`.reference` the NumPy oracle the tests hold it against.
"""
