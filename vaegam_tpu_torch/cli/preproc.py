"""Preprocessing CLI of the port: build the per-volume design CSV.

Host-only (numpy, pandas); the port's own copy of ``vaegam_tpu.cli.preproc``
(importing that module loads JAX), flag for flag the reference
pre_proc_vaefmri.py (:25-42):
  --data_dir --save_dir --control --control_int --set_tag
  --nii_file_pattern --mot_file_pattern --sex_info

Behavioral contract:
  * subject discovery: dirs matching ^sub-A000*, excluding sub-A00058952
    (pre_proc_vaefmri.py:70-78);
  * one row per volume with columns [subjid, "volume #", nii_path, task,
    x, y, z, rot_x, rot_y, rot_z, sex] (:126-127), written WITH the pandas
    index column;
  * task series from 20 s blocks at TR=1.4 (control vs checker variant);
  * motion columns z-scored globally (population sigma);
  * output name: preproc_dset_zscored_{MM_DD_YYYY}_{TAG}_chkr_simple_ts.csv,
    or ..._{TAG}_large3_{INT}_control_simple_ts.csv when --control (:63-66).

    python -m vaegam_tpu_torch.cli.preproc --data_dir D --save_dir S \
        --control --control_int 400 --sex_info sex.csv
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from ..utils import nifti
from ..utils.signals import control_stimulus_to_neural, stimulus_to_neural
from ..utils.stats import str2bool, zscore

TR = 1.4
SUBJ_RE = re.compile(r"\Asub-A000*")
EXCLUDED_SUBJ = "sub-A00058952"


def build_parser():
    parser = argparse.ArgumentParser(
        description="user args for VAE-GAM preprocessing script."
    )
    parser.add_argument("--data_dir", type=str, metavar="N", default="",
                        help="Root dir where nifty (image) files are located.")
    parser.add_argument("--save_dir", type=str, metavar="N", default="",
                        help="Dir where output from preprocessing script should be saved to.")
    parser.add_argument("--control", type=str2bool, nargs="?", const=True,
                        default=False,
                        help="Boolean flag indicating if csv file created is for running simulations using synthetic (control) data.")
    parser.add_argument("--control_int", type=str, metavar="N", default="",
                        help="Str representing intensity of control stimulus in data csv file points to. Used in name of output file when control==True.")
    parser.add_argument("--set_tag", type=str, metavar="N", default="TRAIN",
                        help="Str indicating which data set (TRAIN, TEST or VAL) this csv file refers to. Used in name of output file.")
    parser.add_argument("--nii_file_pattern", type=str, metavar="N",
                        default="sub-A000*_preproc_bold_brainmasked_resampled.nii.gz",
                        help="General pattern for filenames of nifti files to be used.")
    parser.add_argument("--mot_file_pattern", type=str, metavar="N",
                        default="sub-A000*_task-CHECKERBOARD_acq-1400_desc-confounds_regressors_*.tsv",
                        help="General pattern for filenames of motion files to be used.")
    parser.add_argument("--sex_info", type=str, metavar="N", default="",
                        help="Csv file containing information on subject sex/gender. 2 cols: subjID and binary coded sex - 0(MALE) and 1(FEMALE)")
    return parser


def discover_subjects(data_dir: str):
    subjs = []
    for d in sorted(os.listdir(data_dir)):
        if SUBJ_RE.search(d) and EXCLUDED_SUBJ not in d:
            subjs.append(d)
    return subjs


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.data_dir == "":
        args.data_dir = os.getcwd()
    elif not os.path.exists(args.data_dir):
        print("Data dir given does not exist!")
        print("Cannot proceed w/out data!")
        sys.exit(1)

    if args.save_dir == "":
        args.save_dir = os.getcwd()
    elif not os.path.exists(args.save_dir):
        os.makedirs(args.save_dir)

    csv_name_suffix = f"_{args.set_tag}_chkr_simple_ts.csv"
    if args.control:
        assert args.control_int != "", (
            "You need to provide an intensity value if creating a csv for "
            "control/synthetic data!"
        )
        csv_name_suffix = (
            f"_{args.set_tag}_large3_{args.control_int}_control_simple_ts.csv"
        )

    subjs = discover_subjects(args.data_dir)

    samples = []
    sex_df = pd.read_csv(args.sex_info)
    for subj in subjs:
        full_path = os.path.join(args.data_dir, subj)
        nii_files = [str(p) for p in Path(full_path).rglob(args.nii_file_pattern)]
        mot_files = [str(p) for p in Path(full_path).rglob(args.mot_file_pattern)]
        if not nii_files or not mot_files:
            continue
        raw_nii, raw_reg = nii_files[0], mot_files[0]
        subj_sex = sex_df.loc[sex_df["subjID"] == subj, "gender "].iloc[0]
        regressors = pd.read_csv(raw_reg, sep="\t", index_col=False)
        img = nifti.load(raw_nii)
        vols = img.shape[3]
        vol_times = np.arange(1, vols + 1) * TR
        neural = (
            control_stimulus_to_neural(vol_times)
            if args.control
            else stimulus_to_neural(vol_times)
        )
        for vol in range(vols):
            samples.append(
                (subj, vol, raw_nii, neural[vol],
                 regressors["trans_x"][vol], regressors["trans_y"][vol],
                 regressors["trans_z"][vol], regressors["rot_x"][vol],
                 regressors["rot_y"][vol], regressors["rot_z"][vol],
                 subj_sex)
            )

    new_df = pd.DataFrame(
        samples,
        columns=["subjid", "volume #", "nii_path", "task", "x", "y", "z",
                 "rot_x", "rot_y", "rot_z", "sex"],
    )
    zscored_df = zscore(new_df)
    ts = datetime.datetime.now().date()
    csv_name = "preproc_dset_zscored_" + ts.strftime("%m_%d_%Y") + csv_name_suffix
    save_path = os.path.join(args.save_dir, csv_name)
    zscored_df.to_csv(save_path)
    print(save_path)
    return save_path


if __name__ == "__main__":
    main()
