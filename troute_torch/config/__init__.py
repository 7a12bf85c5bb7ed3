from troute_torch.config.schema import Config, load_config
