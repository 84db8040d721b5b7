"""Worker process for tests/test_torch_distributed.py (and chip_smoke.py's
path parallel): bring up the gloo process group from the SEQALIGN_*
environment, score or align the shared input file with the port, print
the gathered result as one JSON line.  It imports only the port.

    python tests/_torch_dist_worker.py FILE [--sw] [--align] [--device DEV]
        [--batch N]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seqalign_tpu_torch.parallel.distributed import (  # noqa: E402
    distributed_align_file, distributed_score_file, init_from_env,
)
from seqalign_tpu_torch.scoring.presets import (  # noqa: E402
    scoring_system_default, scoring_system_sw_default,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--sw", action="store_true")
    ap.add_argument("--align", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    multi = init_from_env()
    sc = scoring_system_sw_default() if args.sw else scoring_system_default()
    out = {"multi": multi,
           "pid": int(os.environ.get("SEQALIGN_PROC_ID", "0"))}
    if args.align:
        res = distributed_align_file(sc, args.path, is_sw=args.sw,
                                     batch=args.batch, device=args.device)
        if args.sw:
            out["alns"] = [[(h.result_a, h.result_b, int(h.score),
                             int(h.pos_a), int(h.pos_b)) for h in hits]
                           for hits in res]
        else:
            out["alns"] = [(r.result_a, r.result_b, int(r.score))
                           for r in res]
    else:
        scores = distributed_score_file(sc, args.path, is_sw=args.sw,
                                        batch=args.batch, device=args.device)
        out["scores"] = [int(s) for s in scores]
    print(json.dumps(out))
    if multi:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
