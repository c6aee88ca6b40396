# Copied from boojum_tpu/cs/geometry.py.
"""CS geometry and lookup parameters.

Reference behavior: src/cs/mod.rs — CSGeometry (:218), LookupParameters
(:227-247) and their derived counts.
"""

from __future__ import annotations

from dataclasses import dataclass

# 1-based table ids, as in reference (INITIAL_LOOKUP_TABLE_ID_VALUE)
INITIAL_LOOKUP_TABLE_ID_VALUE = 1


@dataclass(frozen=True)
class CSGeometry:
    num_columns_under_copy_permutation: int
    num_witness_columns: int
    num_constant_columns: int
    max_allowed_constraint_degree: int


@dataclass(frozen=True)
class LookupParameters:
    """Modes: 'none', 'table_id_as_variable', 'table_id_as_constant',
    'specialized_id_as_variable', 'specialized_id_as_constant'."""

    mode: str = "none"
    width: int = 0
    num_repetitions: int = 0
    share_table_id: bool = False

    @property
    def lookup_is_allowed(self) -> bool:
        return self.mode != "none"

    @property
    def is_specialized(self) -> bool:
        return self.mode.startswith("specialized")

    @property
    def id_in_constant(self) -> bool:
        return self.mode.endswith("as_constant")

    def lookup_width(self) -> int:
        return self.width

    def num_sublookup_arguments_for_geometry(self, geometry: CSGeometry) -> int:
        """How many independent lookup argument columns sets exist
        (reference src/cs/mod.rs LookupParameters impl)."""
        if self.mode == "none":
            return 0
        if self.is_specialized:
            return self.num_repetitions
        principal_width = self.width + (0 if self.id_in_constant else 1)
        return geometry.num_columns_under_copy_permutation // principal_width

    def specialized_columns_per_repetition(self) -> int:
        """Variable columns per lookup repetition in specialized mode."""
        if not self.is_specialized:
            return 0
        return self.width + (0 if self.id_in_constant else 1)

    def columns_per_subargument(self) -> int:
        """Variable columns per sub-argument in GENERAL-PURPOSE modes
        (reference src/cs/mod.rs:293 columns_per_subargument)."""
        assert self.lookup_is_allowed and not self.is_specialized
        return self.width + (0 if self.id_in_constant else 1)

    def total_specialized_lookup_variable_columns(self) -> int:
        return self.specialized_columns_per_repetition() * self.num_repetitions

    def total_specialized_lookup_constant_columns(self) -> int:
        if not (self.is_specialized and self.id_in_constant):
            return 0
        return 1 if self.share_table_id else self.num_repetitions

    @staticmethod
    def no_lookup() -> "LookupParameters":
        return LookupParameters()

    @staticmethod
    def specialized_with_table_id_as_constant(width: int, num_repetitions: int,
                                              share_table_id: bool = True):
        return LookupParameters("specialized_id_as_constant", width,
                                num_repetitions, share_table_id)

    @staticmethod
    def table_id_as_constant(width: int, share_table_id: bool = True):
        return LookupParameters("table_id_as_constant", width, 0, share_table_id)

    @staticmethod
    def table_id_as_variable(width: int, share_table_id: bool = False):
        return LookupParameters("table_id_as_variable", width, 0, share_table_id)

    @staticmethod
    def specialized_with_table_id_as_variable(width: int, num_repetitions: int,
                                              share_table_id: bool = False):
        return LookupParameters("specialized_id_as_variable", width,
                                num_repetitions, share_table_id)


def num_multiplicity_polys(lookup_params: LookupParameters, total_tables_len: int,
                           max_trace_len: int) -> int:
    if not lookup_params.lookup_is_allowed:
        return 0
    assert total_tables_len <= max_trace_len, \
        "all lookup tables must fit in one trace column"
    return 1
