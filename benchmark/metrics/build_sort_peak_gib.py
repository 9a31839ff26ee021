"""build_sort_peak_gib: the card allocator's peak at the end of the suffix
sort, the stage ``build.sort`` of the program's record of its latest build
(``bwt_tpu_torch.index.LAST_BUILD``), in GiB: the build's peak whenever the
sort sets it (build_peak_gib); None on the CPU or where the program keeps
no such record."""

import sys

STAGE = "build.sort"


def read(run):
    record = getattr(sys.modules.get("bwt_tpu_torch.index"), "LAST_BUILD",
                     None)
    peak = getattr(record, "peaks", {}).get(STAGE)
    return None if peak is None else peak / 2 ** 30
