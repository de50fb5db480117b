"""The port's command-line entry points (counterparts of the repo's
``tools/``): train, test_vpq, eval_vpq, eval_ipq, preset_accuracy, the
detection evaluation's coco_eval, voc_eval, coco_error_analysis,
test_robustness, robustness_eval and convert_datasets.pascal_voc, and the
utilities analyze_logs, get_flops, publish_model, upgrade_model_version,
profile_train, profile_ops and profile_sections; each is run as ``python
-m vps_torch.tools.<name>`` and has ``main(argv)`` for callers in the same
process. The distributed launchers are ``dist_train.sh`` and
``slurm_train.sh``."""
