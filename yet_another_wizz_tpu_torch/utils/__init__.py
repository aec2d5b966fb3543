"""Shared utilities: serialisation ABCs, formatting, logging, plotting."""

from yet_another_wizz_tpu_torch.utils.misc import (
    HDF_COMPRESSION,
    common_len_assert,
    format_float_fixed_width,
    format_long_num,
    format_time,
    groupby,
    is_legacy_dataset,
    load_version_tag,
    write_version_tag,
    write_yaml,
)

__all__ = [
    "HDF_COMPRESSION",
    "common_len_assert",
    "format_float_fixed_width",
    "format_long_num",
    "format_time",
    "groupby",
    "is_legacy_dataset",
    "load_version_tag",
    "write_version_tag",
    "write_yaml",
]
