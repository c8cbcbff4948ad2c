"""The dense GQA decoder, served through the paged KV arena."""
