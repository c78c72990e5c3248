"""Evaluation helpers of the port: the OCR judge (``ocr``)."""
