"""Command-line tools: resample_wav, resample_info, analyze_filter."""
