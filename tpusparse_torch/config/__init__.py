from tpusparse_torch.config.options import Options, load_options, parse_options_file

__all__ = ["Options", "load_options", "parse_options_file"]
