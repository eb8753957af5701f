"""Host tools: the watermark mask and the sampling-pattern writer."""
