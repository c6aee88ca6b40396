# Copied from boojum_tpu/prover/serialization.py (the setup-base npz format).
"""Setup-base persistence: the reference's ``save_setup_base`` npz format.

`load_setup_base` reads files the JAX package's ``save_setup_base`` wrote,
and `setup_base_from_arrays` builds the same SetupBase from numpy arrays, so
one setup can feed both packages.
"""

from __future__ import annotations

import json

import numpy as np

from ..cs.setup import SetupBase


# -- setup base (bulk columns as npz) ---------------------------------------


def save_setup_base(path: str, sb: SetupBase):
    np.savez_compressed(
        path,
        copy_permutation_polys=sb.copy_permutation_polys,
        constant_columns=sb.constant_columns,
        lookup_tables_columns=sb.lookup_tables_columns,
        meta=np.frombuffer(json.dumps({
            "table_ids_column_idxes": sb.table_ids_column_idxes,
            "selector_paths": sb.selector_paths,
            "quotient_degree": sb.quotient_degree,
            "num_general_constant_columns": sb.num_general_constant_columns,
            "domain_size": sb.domain_size,
            "public_inputs": sb.public_inputs,
        }).encode(), dtype=np.uint8),
    )


def load_setup_base(path: str) -> SetupBase:
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    return SetupBase(
        copy_permutation_polys=z["copy_permutation_polys"],
        constant_columns=z["constant_columns"],
        lookup_tables_columns=z["lookup_tables_columns"],
        table_ids_column_idxes=list(meta["table_ids_column_idxes"]),
        selectors_placement=None,  # paths are the operative data
        selector_paths=[list(map(bool, p)) for p in meta["selector_paths"]],
        quotient_degree=meta["quotient_degree"],
        num_general_constant_columns=meta["num_general_constant_columns"],
        domain_size=meta["domain_size"],
        public_inputs=[tuple(p) for p in meta["public_inputs"]],
    )


def setup_base_from_arrays(copy_permutation_polys, constant_columns,
                           lookup_tables_columns, table_ids_column_idxes,
                           selector_paths, quotient_degree,
                           num_general_constant_columns, domain_size,
                           public_inputs) -> SetupBase:
    """SetupBase from the fields `save_setup_base` stores, as numpy arrays
    and plain Python values."""
    return SetupBase(
        copy_permutation_polys=np.asarray(copy_permutation_polys, np.uint64),
        constant_columns=np.asarray(constant_columns, np.uint64),
        lookup_tables_columns=np.asarray(lookup_tables_columns, np.uint64),
        table_ids_column_idxes=[int(i) for i in table_ids_column_idxes],
        selectors_placement=None,  # paths are the operative data
        selector_paths=[list(map(bool, p)) for p in selector_paths],
        quotient_degree=int(quotient_degree),
        num_general_constant_columns=int(num_general_constant_columns),
        domain_size=int(domain_size),
        public_inputs=[tuple(int(x) for x in p) for p in public_inputs],
    )
