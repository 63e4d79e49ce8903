"""Raw sqMass QA on the PyTorch port (the counterpart of
examples/inspect_sqmass.py): isolation windows, spectra counts, RT/m-z
coverage, through the port's ``SqMassLoader`` and its native decoder.

Usage: python examples/inspect_sqmass_torch.py RUN.sqMass [--iso-index 0] [--device cuda]

The reading is host work; like every port entry point it names the CUDA
card unless ``--device`` names another device, and without a card and
without ``--device`` it fails.
"""

import argparse
import sys


def report(path: str, iso_index: int = 0) -> list:
    """The JAX script's lines for the sqMass file at ``path``."""
    from dquartic_tpu_torch.data.sqmass import SqMassLoader
    from dquartic_tpu_torch.native import native_available

    lines = [f"native decoder: {'yes' if native_available() else 'no (python fallback)'}"]
    loader = SqMassLoader(path)
    loader.load_all_data()
    iso = loader.iso_win_info
    lines.append(f"\nisolation windows: {len(iso)}")
    lines.append(iso.to_string(index=False, max_rows=20))
    for level, df in [(1, loader.ms1_data), (2, loader.ms2_data)]:
        spectra = df["SPECTRUM_ID"].nunique()
        lines.append(
            f"\nMS{level}: {spectra} spectra, {len(df)} points, "
            f"RT [{df['RETENTION_TIME'].min():.1f}, {df['RETENTION_TIME'].max():.1f}] s, "
            f"m/z [{df['mz'].min():.2f}, {df['mz'].max():.2f}]")
    row = iso.iloc[iso_index]
    ms1 = loader.extract_ms1_slice(row, num_bins=50)
    ms2 = loader.extract_ms2_slice(row, num_bins=1000)
    lines.append(
        f"\nslice for isolation target {row['ISOLATION_TARGET']:.2f}: "
        f"MS1 {len(ms1)} points / {ms1['mz'].nunique()} bins, "
        f"MS2 {len(ms2)} points / {ms2['mz'].nunique()} bins")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sqmass")
    ap.add_argument("--iso-index", type=int, default=0)
    ap.add_argument("--device", default=None, help="(default: the CUDA card)")
    args = ap.parse_args(argv)
    from dquartic_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device, "inspect_sqmass_torch")
    except RuntimeError as e:  # no card and no --device
        sys.exit(str(e))
    for line in report(args.sqmass, args.iso_index):
        print(line)


if __name__ == "__main__":
    main()
