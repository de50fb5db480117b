"""The port's command-line entry points (counterparts of the repo's
``tools/``): train, test_vpq, eval_vpq, eval_ipq, and the detection
evaluation's coco_eval, voc_eval, coco_error_analysis, test_robustness,
robustness_eval and convert_datasets.pascal_voc; each is run as ``python
-m vps_torch.tools.<name>`` and has ``main(argv)`` for callers in the same
process."""
