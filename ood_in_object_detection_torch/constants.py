"""Registries and results-table schemas (reference constants.py)."""

from pathlib import Path

STRIDES_RATIO = [8, 16, 32]  # reference constants.py:12
UNKNOWN_CLASS_INDEX = 80     # reference constants.py:18

COCO_OOD_NAME = "coco_ood"
COCO_MIXED_NAME = "coco_mixed"
COCO_OWOD_TEST_NAME = "owod"
AVAILABLE_DATASETS = [COCO_OOD_NAME, COCO_MIXED_NAME, COCO_OWOD_TEST_NAME]

LOGITS_METHODS = ["NoMethod", "MSP", "Energy", "ODIN", "Sigmoid"]
DISTANCE_METHODS = ["L1_cl_stride", "L2_cl_stride", "Cosine_cl_stride",
                    "Umap", "CosineIvis", "L1Ivis", "L2Ivis"]
OOD_METHOD_CHOICES = LOGITS_METHODS + DISTANCE_METHODS

FTMAPS_RELATED_OPTIONS = ["roi_aligned_ftmaps", "all_ftmaps",
                          "ftmaps_and_strides", "ftmaps_and_strides_exact_pos"]
LOGITS_RELATED_OPTIONS = ["logits"]
INTERNAL_ACTIVATIONS_EXTRACTION_OPTIONS = (
    FTMAPS_RELATED_OPTIONS + LOGITS_RELATED_OPTIONS + ["none"]
)

AVAILABLE_CLUSTERING_METHODS = [
    "one", "all", "DBSCAN", "KMeans", "KMeans_3", "KMeans_5", "KMeans_10",
    "HDBSCAN", "AgglomerativeClustering", "OPTICS", "Birch", "MeanShift",
    "SpectralClustering", "GMM", "BGMM",
]
AVAILABLE_CLUSTER_OPTIMIZATION_METRICS = ["silhouette", "calinski_harabasz"]

TARGETS_RELATED_OPTIONS = ["all_targets_one_stride", "all_targets_all_strides"]
PREDICTIONS_RELATED_OPTIONS = [
    "valid_preds_one_stride", "valid_preds_all_strides", "all_preds_all_strides",
]
IND_INFO_CREATION_OPTIONS = TARGETS_RELATED_OPTIONS + PREDICTIONS_RELATED_OPTIONS

# Results-table column schemas (reference constants.py:49-57)
COMMON_COLUMNS = ["Method", "which_split", "conf_thr_train", "conf_thr_test",
                  "tpr_thr", "cluster_method", "mean_n_clus", "std_n_clus",
                  "fusion_strat"]
VOC_TEST_COLUMN = ["mAP"]
COCO_OOD_COLUMNS = ["U-AP_(COOD)", "U-F1_(COOD)", "U-PRE_(COOD)", "U-REC_(COOD)"]
COCO_MIX_COLUMNS = ["mAP", "U-AP_(CMIX)", "U-F1_(CMIX)", "U-PRE_(CMIX)",
                    "U-REC_(CMIX)", "A-OSE", "WI-08"]
COCO_OWOD_COLUMNS = ["mAP_(OWOD)", "U-AP_(OWOD)", "U-F1_(OWOD)", "U-PRE_(OWOD)",
                     "U-REC_(OWOD)", "A-OSE_(OWOD)", "WI-08_(OWOD)"]
COCO_OWOD_COLUMNS_T1 = ["mAP_(VOC_test)"]
FINAL_COLUMNS = ["Model", "args", "custom_hyp"]

AVAILABLE_BENCHMARKS = ["best_methods", "used_tpr", "conf_thr_train",
                        "conf_thr_test", "which_split_for_ind_scores",
                        "cluster_methods", "logits_methods",
                        "fusion_strategies", "unk_loc_enhancement"]
BENCHMARKS = {
    "best_methods": OOD_METHOD_CHOICES,
    "used_tpr": [0.99, 0.95, 0.90, 0.85, 0.80],
    "conf_thr_train": [0.50, 0.40, 0.35, 0.25, 0.15, 0.05, 0.01, 0.001],
    "conf_thr_test": [0.45, 0.30, 0.15, 0.10, 0.05, 0.01, 0.005, 0.001],
    "which_split_for_ind_scores": ["train", "val", "train_val"],
    "cluster_methods": ["one", "all", "DBSCAN", "KMeans", "KMeans_3", "KMeans_5",
                        "KMeans_10", "HDBSCAN", "AgglomerativeClustering", "Birch"],
    "cluster_perf_metric": AVAILABLE_CLUSTER_OPTIMIZATION_METRICS,
    "logits_methods": LOGITS_METHODS,
    "fusion_strategies": [["fusion-MSP-Sigmoid", "fusion-MSP-CosineIvis",
                           "fusion-CosineIvis-Cosine_cl_stride"],
                          ["and", "or", "score"]],
    "unk_loc_enhancement": [{
        "unk.USE_HEURISTICS": [True],
        "unk.RANK_BOXES": [True],
        "unk.THRESHOLDING_METHOD": ["recursive_otsu"],
        "unk.NUM_THRESHOLDS": [3],
        "unk.rank.MAX_NUM_UNK_BOXES_PER_IMAGE": [3, 5, 7],
        "unk.rank.NMS": [0.25, 0.5, 0.75],
    }],
}

ROOT = Path(__file__).resolve().parents[1]
STORAGE_PATH = ROOT / "storage"
TEMPORAL_STORAGE_PATH = STORAGE_PATH / "temp"
RESULTS_PATH = ROOT / "results"
INDIVIDUAL_RESULTS_FILE_PATH = RESULTS_PATH / "individual_results"
