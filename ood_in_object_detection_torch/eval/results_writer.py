"""Results CSV/XLSX writer with the reference column schema.

Mirrors append_results_to_xlsx_and_csv + the row-building helpers
(ood_evaluation.py:1353-1429, schema constants.py:49-57) so downstream
aggregation tooling (process_results.ipynb-style) keeps working.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..constants import (
    COCO_MIX_COLUMNS,
    COCO_OOD_COLUMNS,
    COCO_OWOD_COLUMNS,
    COCO_OWOD_COLUMNS_T1,
    COMMON_COLUMNS,
    FINAL_COLUMNS,
)
from ..core.config import CUSTOM_HYP, hyperparams_to_dict


def method_info_row(method, which_split: str, conf_thr_train: float,
                    conf_thr_test: float, tpr_thr: float,
                    fusion_strategy: str = "none") -> Dict:
    """reference fill_dict_with_method_info (ood_evaluation.py:1353-1364)."""
    row = {
        "Method": getattr(method, "name", str(method)),
        "which_split": which_split,
        "conf_thr_train": conf_thr_train,
        "conf_thr_test": conf_thr_test,
        "tpr_thr": tpr_thr,
        "cluster_method": getattr(method, "cluster_method", "None"),
        "fusion_strat": fusion_strategy,
    }
    n_clus = cluster_counts(method)
    row["mean_n_clus"] = float(np.mean(n_clus)) if n_clus else 0.0
    row["std_n_clus"] = float(np.std(n_clus)) if n_clus else 0.0
    return row


def cluster_counts(method) -> List[int]:
    clusters = getattr(method, "clusters", None)
    if clusters is None:
        return []
    out = []
    for row in clusters:
        for c in row:
            if isinstance(c, np.ndarray) and c.ndim == 2:
                out.append(c.shape[0])
    return out


def dataset_result_columns(dataset_name: str, owod_task_ood: str = "") -> List[str]:
    if dataset_name == "coco_ood":
        return COCO_OOD_COLUMNS
    if dataset_name == "coco_mixed":
        return COCO_MIX_COLUMNS
    if dataset_name == "owod":
        return COCO_OWOD_COLUMNS_T1 if owod_task_ood == "t1" else COCO_OWOD_COLUMNS
    raise ValueError(dataset_name)


def fill_dataset_results(row: Dict, dataset_name: str, metrics: Dict[str, float],
                         owod_task_ood: str = "") -> None:
    """reference fill_dict_with_one_dataset_results (ood_evaluation.py:1365-1382)."""
    cols = dataset_result_columns(dataset_name, owod_task_ood)
    key_map = {
        "U-AP_(COOD)": "U-AP", "U-F1_(COOD)": "U-F1",
        "U-PRE_(COOD)": "U-PRE", "U-REC_(COOD)": "U-REC",
        "U-AP_(CMIX)": "U-AP", "U-F1_(CMIX)": "U-F1",
        "U-PRE_(CMIX)": "U-PRE", "U-REC_(CMIX)": "U-REC",
        "mAP": "mAP", "A-OSE": "A-OSE", "WI-08": "WI-08",
        "mAP_(VOC_test)": "mAP",
        "mAP_(OWOD)": "mAP", "U-AP_(OWOD)": "U-AP", "U-F1_(OWOD)": "U-F1",
        "U-PRE_(OWOD)": "U-PRE", "U-REC_(OWOD)": "U-REC",
        "A-OSE_(OWOD)": "A-OSE", "WI-08_(OWOD)": "WI-08",
    }
    for col in cols:
        row[col] = metrics.get(key_map.get(col, col), float("nan"))


def finalize_row(row: Dict, model_name: str, args: Optional[Dict] = None) -> Dict:
    row["Model"] = model_name
    row["args"] = str(args or {})
    row["custom_hyp"] = str(hyperparams_to_dict(CUSTOM_HYP))
    return row


def append_results(rows: List[Dict], out_dir: str, name: str) -> Path:
    """Append rows to <out_dir>/<stamp>_<name>.csv (+ .xlsx when openpyxl is
    available), reference ood_evaluation.py:1408-1429."""
    import pandas as pd

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    csv_path = out / f"{stamp}_{name}.csv"
    df = pd.DataFrame(rows)
    ordered = [c for c in COMMON_COLUMNS if c in df.columns]
    ordered += [c for c in df.columns if c not in ordered and c not in FINAL_COLUMNS]
    ordered += [c for c in FINAL_COLUMNS if c in df.columns]
    df = df[ordered]
    df.to_csv(csv_path, index=False)
    try:
        df.to_excel(csv_path.with_suffix(".xlsx"), index=False)
    except Exception:
        pass
    return csv_path
