"""Probe and measurement scripts of the port, run as modules
(``python -m ood_in_object_detection_torch.scripts.<name>``)."""
