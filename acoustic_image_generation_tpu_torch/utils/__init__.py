"""Run logging without TensorFlow: TensorBoard event files, ``metrics.jsonl``
and media files."""
