"""``python -m apex_tpu_torch.resilience.remediation.launch [torchrun
options] command ...``: ``torch.distributed.run`` that exits with its
ranks' own exit code.

``torch.distributed.run`` ends with 1 whenever a rank fails, whatever
code the rank exited with. The supervisor acts on those codes
(``resilience/exit_codes.py``: 43 restart, 44 restart on the persisted
device count, 45 halt), so this launcher runs the same agent with the
same options and exits with the code of the first rank that failed,
128 + N for a rank that signal N ended.
"""

import sys
from typing import List, Optional

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    from torch.distributed.elastic.multiprocessing.errors import (
        ChildFailedError,
    )
    from torch.distributed.run import parse_args, run

    try:
        run(parse_args(argv))
    except ChildFailedError as e:
        _, failure = e.get_first_failure()
        code = failure.exitcode
        return code if code >= 0 else 128 - code
    return 0


if __name__ == "__main__":
    sys.exit(main())
