"""Full-scale reference-schema worker-file export.

Exports all 1152 per-region worker files (write_trained_res schema,
src/mod_reservoir.f90:1703-1738 / mod_io.f90:2938-3036 layout) from the
persisted reference-scale weight bank, reads a sample back through
import_worker_files, verifies round-trip equality, and records wall/size.

The dense (n, n_in) win block the schema requires is ~26 MB f8 per file
(~39 GB for the full set) — use --keep to retain everything; the default
deletes all but --keep-samples files after verification so the exercise
fits the build disk.

Usage:
  python scripts/export_workers.py --weights data/refscale_weights.nc
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")   # host-side I/O exercise

    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--out", default="data/worker_files")
    ap.add_argument("--trial", default="refscale")
    ap.add_argument("--keep", action="store_true",
                    help="keep every exported file (needs ~39 GB)")
    ap.add_argument("--keep-samples", type=int, default=2)
    ap.add_argument("--verify-regions", type=int, nargs="*",
                    default=[0, 577, 1151])
    ap.add_argument("--results", default="data/worker_export.json")
    args = ap.parse_args()

    from speedyml.io.weights import load_model, import_worker_files

    t0 = time.time()
    hm = load_model(args.weights)
    t_load = time.time() - t0
    L = hm.layout
    print(f"model loaded in {t_load:.0f}s: R={L.R}, "
          f"wout {hm.params.wout.shape}", flush=True)

    from speedyml.io.weights import export_worker_files
    t0 = time.time()
    export_worker_files(args.out, hm, trial_name=args.trial)
    t_export = time.time() - t0
    files = sorted(glob.glob(os.path.join(args.out, "worker_*.nc")))
    total_bytes = sum(os.path.getsize(f) for f in files)
    print(f"exported {len(files)} files, {total_bytes/1e9:.2f} GB "
          f"in {t_export:.0f}s", flush=True)

    # read the FULL set back through the reference-schema importer
    t0 = time.time()
    hm2 = import_worker_files(args.out, L, hm.rcfg, trial_name=args.trial)
    t_import = time.time() - t0
    p, p2 = hm.params, hm2.params
    np.testing.assert_allclose(np.asarray(p2.wout), np.asarray(p.wout),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p2.win), np.asarray(p.win),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(p2.a_idx), np.asarray(p.a_idx))
    assert p2.a_shift is not None, "circulant structure lost in round trip"
    print(f"full {L.R}-region round trip verified ({t_import:.0f}s)",
          flush=True)

    res = dict(files=len(files), total_gb=round(total_bytes / 1e9, 2),
               export_s=round(t_export, 1), import_sample_s=round(t_import, 1),
               per_file_mb=round(total_bytes / len(files) / 1e6, 2),
               verified_regions=args.verify_regions)
    if not args.keep:
        for f in files[args.keep_samples:]:
            os.unlink(f)
        res["kept_files"] = args.keep_samples
        print(f"cleaned up (kept {args.keep_samples} samples + controller)")
    with open(args.results, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    print("EXPORT OK")


if __name__ == "__main__":
    main()
