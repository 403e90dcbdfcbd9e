from .pipeline import SyntheticLM, TokenFileDataset, make_dataset, write_token_file  # noqa: F401
